"""PyTorch port: the two text models through the 2.0 high-level API's
``Model.fit`` in dygraph, against the JAX package's, on the CPU, at small
widths (``torch_text_models.py``):

- Transformer NMT (vocabulary 40, d_model 16, 2 heads, 1 + 1 layers, FFN
  32) on reversal pairs, soft-label cross entropy on smoothed one-hot
  labels, Adam(0.9, 0.98, 1e-9) under ``NoamDecay`` stepped by the
  ``LRScheduler`` callback;
- the PTB LSTM language model (2 layers, hidden 16) on ``Imikolov``
  NGRAM windows of a synthetic ``simple-examples`` tarball, SGD at
  lr 1.0 with ``ClipGradByGlobalNorm(10)``.

Both start from the JAX model's ``state_dict()``, dropout 0 (the
packages' random streams differ), the same batches in the same order.
Step 1's loss agrees within 1e-5 relative (float32 in other summation
orders, before any update); the later steps' within 1e-4 (each update
carries the first step's float32 gaps forward).

The static adapter: the JAX package's fails on both models with an
``IndexError`` (its layers read a batch size the 2.0 layers' static
outputs do not carry), pinned; the port's raises
``NotImplementedError`` naming the missing shape.
"""
import io
import tarfile

import numpy as np
import pytest

from torch_dygraph_parity import _jax_eager_keys_kept, J, T  # noqa: F401
import torch_text_models as tm

VOCAB, D, FFN, LEN, BOS = 40, 16, 32, 6, 1
HIDDEN, WINDOW = 16, 8


def _nmt(p, dropout=0.0):
    return tm.seq2seq(p, VOCAB, D, 2, 1, FFN, dropout, max_len=LEN)


def _nmt_batches():
    src, tgt, label = tm.reversal_pairs(12, LEN, VOCAB, BOS, seed=0)
    return [(src[i:i + 4], tgt[i:i + 4], label[i:i + 4])
            for i in range(0, 12, 4)]


@pytest.fixture(scope="module")
def ptb(tmp_path_factory):
    """A ``simple-examples`` tarball: 60 lines of 8 to 20 words over a
    skewed 30-word vocabulary, and 10 validation lines."""
    rs = np.random.RandomState(1)
    words = [f"w{i}" for i in range(30)]
    prob = 1.0 / np.arange(1, 31)
    path = str(tmp_path_factory.mktemp("ptb") / "simple-examples.tgz")
    with tarfile.open(path, "w:gz") as tf:
        for split, n in (("train", 60), ("valid", 10)):
            text = "".join(" " + " ".join(rs.choice(
                words, rs.randint(8, 21), p=prob / prob.sum())) + " \n"
                for _ in range(n)).encode()
            info = tarfile.TarInfo(f"./simple-examples/data/ptb.{split}.txt")
            info.size = len(text)
            tf.addfile(info, io.BytesIO(text))
    return path


def _lm_setup(p, ptb, dropout=0.0):
    ds = p.text.datasets.Imikolov(ptb, "NGRAM", WINDOW, min_word_freq=5)
    vocab = len(ds.word_idx)
    win = tm.Windows(ds)
    batches = []
    for b in range(3):
        items = [win[i] for i in range(b * 5, b * 5 + 5)]
        batches.append(tuple(np.stack(col) for col in zip(*items)))
    return tm.language_model(p, vocab, HIDDEN, 2, dropout), batches


def _prepare(p, net, kind):
    if kind == "nmt":
        opt = p.optimizer.Adam(
            learning_rate=p.optimizer.lr.NoamDecay(D, 4), beta1=0.9,
            beta2=0.98, epsilon=1e-9, parameters=net.parameters())
        loss = tm.smoothed_cross_entropy(p, VOCAB)
    else:
        opt = p.optimizer.SGD(learning_rate=1.0, parameters=net.parameters(),
                              grad_clip=p.nn.ClipGradByGlobalNorm(10.0))
        loss = p.nn.CrossEntropyLoss()
    model = p.Model(net)
    model.prepare(opt, loss)
    return model


def _fit_losses(p, model, batches):
    class Losses(p.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))

    rec = Losses()
    model.fit(batches, epochs=1, verbose=0,
              callbacks=[rec, p.callbacks.LRScheduler()])
    return np.asarray(rec.losses)


def _both(kind, ptb):
    nets, batches = {}, None
    for p in (J, T):
        p.seed(0)
        if kind == "nmt":
            nets[p], batches = _nmt(p), _nmt_batches()
        else:
            nets[p], batches = _lm_setup(p, ptb)
    sd = {k: np.asarray(v.numpy()) for k, v in nets[J].state_dict().items()}
    assert list(sd) == list(nets[T].state_dict())
    T.dygraph.state_dict_from_numpy(nets[T], sd)
    return [_fit_losses(p, _prepare(p, nets[p], kind), batches)
            for p in (J, T)]


@pytest.mark.parametrize("kind", ["nmt", "lm"])
def test_fit_matches_jax(kind, ptb):
    want, got = _both(kind, ptb)
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _static_model(p, kind, ptb):
    """``kind``'s model in a static ``Model`` over int64 InputSpecs
    (construction only: ``prepare`` builds the programs)."""
    p.seed(0)
    if kind == "nmt":
        net = _nmt(p)
        ins = [p.InputSpec([None, LEN], "int64", "src"),
               p.InputSpec([None, LEN], "int64", "tgt")]
        lbl = [p.InputSpec([None, LEN], "int64", "label")]
    else:
        net, _ = _lm_setup(p, ptb)
        ins = [p.InputSpec([None, WINDOW - 1], "int64", "ids")]
        lbl = [p.InputSpec([None, WINDOW - 1, 1], "int64", "label")]
    p.enable_static()
    return net, p.Model(net, inputs=ins, labels=lbl)


def _static_prepare(p, net, model, kind):
    model.prepare(p.optimizer.SGD(learning_rate=0.1,
                                  parameters=net.parameters()),
                  tm.smoothed_cross_entropy(p, VOCAB) if kind == "nmt"
                  else p.nn.CrossEntropyLoss())


@pytest.mark.parametrize("kind", ["nmt", "lm"])
def test_jax_static_adapter_fails_on_text_models(kind, ptb):
    """The JAX package's static adapter reads a shape its static outputs
    lack: ``nn.LSTM``'s zero state (``x.shape[0]``) and
    ``MultiHeadAttention._shape`` (``x.shape[0], x.shape[1]``)."""
    try:
        net, model = _static_model(J, kind, ptb)
        with pytest.raises(IndexError, match="out of range"):
            _static_prepare(J, net, model, kind)
    finally:
        J.disable_static()


@pytest.mark.parametrize("kind", ["nmt", "lm"])
def test_port_static_adapter_names_the_missing_shape(kind, ptb):
    """The port's static adapter stops at the same place, naming the
    layer, the shape it lacks and the ROADMAP items that bring it."""
    who = "MultiHeadAttention" if kind == "nmt" else "LSTM"
    try:
        net, model = _static_model(T, kind, ptb)
        with pytest.raises(NotImplementedError,
                           match=rf"{who}: input .* has no known shape"
                                 r".*Queue A item 6"):
            _static_prepare(T, net, model, kind)
    finally:
        T.disable_static()
