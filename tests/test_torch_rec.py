"""PyTorch port: the one-process recommender path (``rec.wide_deep_*``)
and the ``is_sparse`` embedding lookup it runs, against the JAX package.

- ``lookup_table_v2`` / ``lookup_table`` with ``is_sparse=True``: ids
  outside [0, vocab) (negative and too large) and ``padding_idx`` give
  zero rows, and the table's gradient has no contribution from them
  (its padding row exactly 0), equal to the JAX package's
  ``embedding_lookup_ref`` fallback (float32, 1e-6).
- Each lowering counts ``emb_sparse_fallback_dense``; the warning comes
  once a process.  A row-sharded table still raises the later-slice
  error.
- ``wide_deep_program(sparse=True, padding_idx=0)`` at a small width
  (batch 8, vocab 50, emb 4, 3 fields, 2 dense, hidden (8, 4)) trains 3
  SGD steps from the JAX startup's values on feeds holding padding and
  out-of-vocab ids: losses and parameters within 1e-5 of the JAX
  package's.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
import test_torch_lowerings as tl
from paddle_tpu_torch.framework.scope import scope_from_numpy
from paddle_tpu_torch.monitor import stat_get, stat_reset
from paddle_tpu_torch.ops import embedding_ops

VOCAB, EMB = 10, 4
WD = dict(batch_size=8, vocab_size=50, emb_dim=4, n_fields=3, n_dense=2,
          hidden=(8, 4), padding_idx=0, sparse=True, lr=0.05)


def _ids(shape):
    rs = np.random.RandomState(3)
    ids = rs.randint(0, VOCAB, shape).astype("int64")
    flat = ids.reshape(-1)
    flat[:4] = [VOCAB, VOCAB + 5, -1, 2]      # two too large, one negative
    return ids


@pytest.mark.parametrize("op_type", ["lookup_table_v2", "lookup_table"])
def test_sparse_lookup_zero_rows_and_gradient_match_jax(op_type):
    ids = _ids((3, 4))
    if op_type == "lookup_table":
        ids = ids[..., None]
    w = np.random.RandomState(0).randn(VOCAB, EMB).astype("f4")
    case = tl._case(op_type, dict(W=[w], Ids=[ids]), ["Out"],
                    dict(padding_idx=2, is_sparse=True),
                    tol=dict(rtol=0, atol=1e-6))
    stat_reset("emb_sparse_fallback_dense")
    pairs = tl.check_case(op_type, case)
    assert stat_get("emb_sparse_fallback_dense") >= 1
    out = pairs["out_out"][0].reshape(-1, EMB)
    flat = ids.reshape(-1)
    bad = (flat < 0) | (flat >= VOCAB) | (flat == 2)
    assert bad.sum() >= 4 and not out[bad].any()
    np.testing.assert_array_equal(out[~bad], w[flat[~bad]])
    grad = next(g for n, (g, _w) in pairs.items() if "w" in n.lower()
                and "grad" in n.lower())
    assert not grad[2].any()                     # the padding row
    assert grad[flat[~bad]].any(axis=1).all()


def test_counter_moves_and_warning_once(monkeypatch):
    import torch

    from paddle_tpu_torch.framework.program import Operator

    monkeypatch.setattr(embedding_ops, "_warned_sparse_fallback", False)
    op = Operator.__new__(Operator)
    op.callstack = ["model.py:1"]
    stat_reset("emb_sparse_fallback_dense")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for _ in range(3):
            embedding_ops._warn_sparse_fallback(op)
    assert stat_get("emb_sparse_fallback_dense") == 3
    assert len([w for w in seen if "is_sparse=True" in str(w.message)]) == 1
    w = torch.randn(VOCAB, EMB)
    out = embedding_ops.embedding_lookup_ref(
        w, torch.tensor([[0, 3, VOCAB]]), padding_idx=0)
    assert not out[0, 0].any() and not out[0, 2].any()
    assert torch.equal(out[0, 1], w[3])


def test_row_sharded_table_still_raises_later():
    from paddle_tpu_torch.dygraph.eager import run_op

    T.set_device("cpu")
    ids = T.to_tensor(np.array([[1, 2]], "int64"))
    w = T.to_tensor(np.ones((4, 3), "f4"))
    with pytest.raises(NotImplementedError, match="item 8"):
        run_op("lookup_table_v2", {"Ids": ids, "W": w},
               {"is_sparse": True, embedding_ops.EMB_SHARD_ATTR: 2},
               out_slots=("Out",))


def _wd_feeds(steps):
    rs = np.random.RandomState(5)
    out = []
    for _ in range(steps):
        ids = rs.randint(0, WD["vocab_size"],
                         (WD["batch_size"], WD["n_fields"])).astype("int64")
        ids[0, 0] = 0                            # padding
        ids[1, 1] = WD["vocab_size"] + 7         # out of vocabulary
        out.append({"sparse_ids": ids,
                    "dense_x": rs.randn(WD["batch_size"],
                                        WD["n_dense"]).astype("f4"),
                    "labels": rs.randint(0, 2, (WD["batch_size"], 1))
                    .astype("int64")})
    return out


def _wide_deep(p):
    from importlib import import_module

    unique = import_module(p.__name__ + ".framework.unique_name")
    prog = import_module(p.__name__ + ".framework.program")
    rec = import_module(p.__name__ + ".rec")
    with unique.guard():
        main, startup, _feeds, loss, opt = rec.wide_deep_program(**WD)
        with prog.program_guard(main, startup):
            opt.minimize(loss)
    return main, startup, loss


def test_wide_deep_sparse_three_steps_match_jax():
    jmain, jstart, jloss = _wide_deep(J)
    jscope = J.framework.Scope()
    jexe = J.Executor(J.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.get_var(v.name))
            for v in jstart.global_block.vars.values() if v.persistable}
    assert {"wd_table", "wd_wide_table"} <= set(init)
    feeds = _wd_feeds(3)
    want = [np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                scope=jscope)[0]).item() for f in feeds]
    tmain, _s, tloss = _wide_deep(T)
    assert all(op.attr("is_sparse") for op in tmain.global_block.ops
               if op.type.startswith("lookup_table"))
    tscope = scope_from_numpy(init, "cpu")
    texe = T.Executor(T.CPUPlace())
    stat_reset("emb_sparse_fallback_dense")
    got = [np.asarray(texe.run(tmain, feed=f, fetch_list=[tloss],
                               scope=tscope)[0]).item() for f in feeds]
    assert stat_get("emb_sparse_fallback_dense") >= 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for n in init:
        np.testing.assert_allclose(np.asarray(tscope.get_var(n)),
                                   np.asarray(jscope.get_var(n)),
                                   rtol=0, atol=1e-5, err_msg=n)
    # the padding row of both tables never moves
    for n in ("wd_table", "wd_wide_table"):
        np.testing.assert_array_equal(np.asarray(tscope.get_var(n))[0],
                                      init[n][0])
