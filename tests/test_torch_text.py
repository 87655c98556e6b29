"""PyTorch port: ``text.datasets``, ``text.decode`` and the beam ancestry
walk (``ops.linalg_ops.backtrack_beams``, the ``gather_tree`` op)
against the JAX package's, on the CPU.

- The datasets read synthetic files written here from a seed in the
  reference formats (``housing.data``, an ``aclImdb`` tarball, a
  ``simple-examples`` tarball): every item and the vocabularies equal
  the JAX package's exactly.
- Decoding: ``tests/test_decode.py``'s step model (an embedding, a tanh
  recurrence, an output projection) in numpy weights, run as jax.numpy by
  the JAX package's decoders and as torch by the port's: the ids equal,
  the scores within 1e-5 relative (float32 log-softmax sums over at most
  8 steps, in other summation orders).
- The ancestry walk: equal ids.
"""
import io
import os
import tarfile

import numpy as np
import pytest
import torch

from torch_dygraph_parity import _jax_eager_keys_kept, J, T  # noqa: F401
from test_decode import EOS, H, V, _jax_step_fn, _mk_model
from test_torch_lowerings import PACKAGES, _run

WORDS = [f"w{i}" for i in range(40)]


def _text(rs, n_words):
    """Words drawn with a skewed frequency, so that cutoffs bite."""
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    return " ".join(rs.choice(WORDS, n_words, p=p / p.sum()))


def _add(tf, name, text):
    data = text.encode("latin-1")
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("text_data")
    rs = np.random.RandomState(0)
    housing = str(d / "housing.data")
    np.savetxt(housing, rs.rand(40, 14) * 50)
    imdb = str(d / "aclImdb_v1.tar.gz")
    with tarfile.open(imdb, "w:gz") as tf:
        for mode in ("train", "test"):
            for label in ("pos", "neg"):
                for i in range(6):
                    _add(tf, f"aclImdb/{mode}/{label}/{i}_7.txt",
                         _text(rs, 60).capitalize() + ". <br /><br />Ok!")
    ptb = str(d / "simple-examples.tgz")
    with tarfile.open(ptb, "w:gz") as tf:
        for split, lines in (("train", 30), ("valid", 8)):
            _add(tf, f"./simple-examples/data/ptb.{split}.txt", "".join(
                " " + _text(rs, int(rs.randint(3, 15))) + " \n"
                for _ in range(lines)))
    return dict(housing=housing, imdb=imdb, ptb=ptb)


def _same_items(a, b):
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        x, y = a[i], b[i]
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
            assert np.asarray(u).dtype == np.asarray(v).dtype


@pytest.mark.parametrize("mode", ["train", "test"])
def test_uci_housing_matches_jax(files, mode):
    _same_items(J.text.datasets.UCIHousing(files["housing"], mode),
                T.text.datasets.UCIHousing(files["housing"], mode))


def test_imdb_matches_jax(files):
    for mode in ("train", "test"):
        a = J.text.datasets.Imdb(files["imdb"], mode, cutoff=5)
        b = T.text.datasets.Imdb(files["imdb"], mode, cutoff=5)
        assert a.word_idx == b.word_idx and len(b.word_idx) > 5
        _same_items(a, b)


@pytest.mark.parametrize("data_type", ["NGRAM", "SEQ"])
def test_imikolov_matches_jax(files, data_type):
    for mode in ("train", "test"):
        kw = dict(data_type=data_type, window_size=4, mode=mode,
                  min_word_freq=3)
        a = J.text.datasets.Imikolov(files["ptb"], **kw)
        b = T.text.datasets.Imikolov(files["ptb"], **kw)
        assert a.word_idx == b.word_idx
        assert b.word_idx["<unk>"] == len(b.word_idx) - 1
        _same_items(a, b)


def test_loaders_read_local_files_only(tmp_path):
    """No file: a RuntimeError naming the upstream URL (download=True
    too); a missing path: FileNotFoundError, as in the JAX package."""
    for name, url in (("UCIHousing", "uci_housing/housing.data"),
                      ("Imdb", "aclImdb_v1.tar.gz"),
                      ("Imikolov", "simple-examples.tgz")):
        cls = getattr(T.text.datasets, name)
        with pytest.raises(RuntimeError, match=url):
            cls(download=True)
        with pytest.raises(FileNotFoundError):
            cls(data_file=os.path.join(tmp_path, "absent"))


def _torch_step_fn(model):
    emb, w, out = (torch.from_numpy(m) for m in model)

    def step(tok, h):
        h2 = torch.tanh(emb[tok] + h @ w)
        return h2 @ out, h2

    return step


def _both(fn_name, model_seed, bos, **kw):
    import jax.numpy as jnp
    from paddle_tpu.text import decode as jdecode

    model = _mk_model(model_seed)
    n = len(bos)
    want = getattr(jdecode, fn_name)(_jax_step_fn(model),
                                     jnp.zeros((n, H)), bos, **kw)
    got = getattr(T.text.decode, fn_name)(
        _torch_step_fn(model), torch.zeros(n, H), bos, **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_decoded(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_greedy_matches_jax():
    want, got = _both("greedy_search", 0, np.array([1, 2, 3, 4]),
                      max_len=8, end_id=EOS)
    assert got[0].shape == (4, 8)
    _assert_decoded(want, got)


@pytest.mark.parametrize("alpha", [0.0, 0.6])
@pytest.mark.parametrize("k", [2, 4])
def test_beam_matches_jax(k, alpha):
    """Ids [batch, beam, max_len] best beam first, length-penalized
    scores sorted; several beams end in EOS before max_len."""
    end = 3   # a token the model emits early: finished lanes compete
    want, got = _both("beam_search", 1, np.array([1, 2, 5]), beam_size=k,
                      max_len=7, end_id=end, length_penalty=alpha)
    assert got[0].shape == (3, k, 7)
    assert (got[0][:, :, :-1] == end).any()
    _assert_decoded(want, got)
    assert (np.diff(got[1], axis=1) <= 0).all()


def test_dynamic_decode_dispatch_matches_jax():
    for beam in (None, 1, 3):
        want, got = _both("dynamic_decode", 2, np.array([3, 4]), max_len=6,
                          end_id=EOS, beam_size=beam)
        _assert_decoded(want, got)


def test_backtrack_beams_and_gather_tree_match_jax():
    """The ancestry walk on random ids and parents: the function, and the
    ``gather_tree`` op through each package's executor."""
    from paddle_tpu.ops.linalg_ops import backtrack_beams as jwalk
    from paddle_tpu_torch.ops.linalg_ops import backtrack_beams as twalk

    rs = np.random.RandomState(5)
    ids = rs.randint(0, V, (6, 3, 4)).astype("int64")
    parents = rs.randint(0, 4, (6, 3, 4)).astype("int64")
    want = np.asarray(jwalk(ids, parents))
    np.testing.assert_array_equal(
        twalk(torch.from_numpy(ids), torch.from_numpy(parents)).numpy(),
        want)
    outs = []
    for which in ("jax", "torch"):
        prog = PACKAGES[which][1].Program()
        blk = prog.global_block
        for n, a in (("ids", ids), ("parents", parents)):
            blk.create_var(name=n, shape=a.shape, dtype="int64")
        blk.create_var(name="out")
        blk.append_op("gather_tree", {"Ids": ["ids"], "Parents": ["parents"]},
                      {"Out": ["out"]}, {})
        outs.append(np.asarray(_run(which, prog, {"ids": ids,
                                                  "parents": parents},
                                    ["out"])[0]))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], want)
