"""PyTorch port: the dense op library in a loaded program and through
dygraph's ``Tracer.trace_op``.

- The JAX package builds one program (``append_op``) holding an op of
  each group the port added: ``segment_pool`` (linear algebra),
  ``warpctc`` (losses), ``bilinear_interp_v2`` (resize), ``beam_search``
  and ``squared_l2_norm`` (misc), and the 1.x ``lookup_table``, and
  serializes it (``Program.serialize_to_string``, protobuf).  The port
  parses the bytes with its own wire codec (``framework/ir_wire.py``),
  runs the program on the CPU from ``scope_from_numpy`` of the same
  values, and matches the JAX package's fetches, run from a scope of
  those values.
- ``Tracer.trace_op`` hands ``lookup_table``'s result to the caller's own
  output tensor in both packages, and the gradient of the table through
  it matches.
- The port's ``calc_gradient``, each output seeded with its own
  ``target_gradients`` var (how the card phase builds its gradients),
  gives the input gradients of the JAX package's grad ops fed the same
  cotangents, on ops with several differentiable outputs or inputs.

Tolerance: 1e-5 absolute plus 1e-5 relative (float32 on both sides; the
ids, parents and segment counts equal).
"""
import numpy as np
import pytest

import paddle_tpu as J
import test_torch_lowerings as tl
import paddle_tpu_torch as T
from paddle_tpu.framework import program as jprogram
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework.backward import calc_gradient
from paddle_tpu_torch.framework.scope import scope_from_numpy
from test_torch_linalg_ops import CASES as LINALG
from torch_dygraph_parity import _jax_eager_keys_kept  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _values():
    rs = np.random.RandomState(5)
    f = lambda *s: rs.randn(*s).astype("f4")  # noqa: E731
    ids = rs.randint(0, 12, (3, 4, 1)).astype("int64")
    ids[0, 0, 0] = 0
    return {
        "x": f(6, 3), "seg": np.array([0, 0, 2, 2, 2, 5], "int32"),
        "logits": f(10, 2, 5),
        "label": np.array([[1, 1, 3], [2, 4, 0]], "int32"),
        "logits_len": np.array([10, 7], "int64"),
        "label_len": np.array([3, 2], "int64"),
        "img": f(1, 2, 5, 6),
        "pre_ids": np.array([[0], [1], [3], [1]], "int64"),
        "pre_scores": -np.abs(f(4, 1)),
        "scores": -np.abs(f(4, 7)) - 1.0,
        "table": f(12, 4), "ids": ids,
    }


OPS = (
    ("segment_pool", {"X": ["x"], "SegmentIds": ["seg"]},
     {"Out": ["pool"], "SummedIds": ["summed"]}, {"pooltype": "MAX"}),
    ("warpctc", {"Logits": ["logits"], "Label": ["label"],
                 "LogitsLength": ["logits_len"], "LabelLength": ["label_len"]},
     {"Loss": ["ctc"], "WarpCTCGrad": ["ctc_grad"]},
     {"blank": 0, "norm_by_times": True}),
    ("bilinear_interp_v2", {"X": ["img"]}, {"Out": ["resized"]},
     {"out_h": 9, "out_w": 13, "align_corners": False, "align_mode": 0,
      "data_layout": "NCHW"}),
    ("beam_search", {"pre_ids": ["pre_ids"], "pre_scores": ["pre_scores"],
                     "scores": ["scores"]},
     {"selected_ids": ["sel_ids"], "selected_scores": ["sel_scores"],
      "parent_idx": ["parent"]},
     {"beam_size": 2, "end_id": 1, "is_accumulated": True}),
    ("lookup_table", {"W": ["table"], "Ids": ["ids"]}, {"Out": ["emb"]},
     {"padding_idx": 0, "is_sparse": False}),
    ("squared_l2_norm", {"X": ["emb"]}, {"Out": ["sq"]}, {}),
)
FETCH = ["pool", "summed", "ctc", "resized", "sel_ids", "sel_scores",
         "parent", "emb", "sq"]


def _jax_program(values):
    prog = jprogram.Program()
    blk = prog.global_block
    for name, a in values.items():
        blk.create_var(name=name, shape=a.shape, dtype=a.dtype.name,
                       persistable=True)
    for op_type, ins, outs, attrs in OPS:
        for names in outs.values():
            for n in names:
                blk.create_var(name=n)
        blk.append_op(op_type, ins, outs, attrs)
    return prog


def test_a_loaded_program_matches_jax():
    values = _values()
    data = _jax_program(values).serialize_to_string()
    jscope = J.framework.Scope()
    for name, a in values.items():
        jscope.set_var(name, a)
    want = J.Executor(J.CPUPlace()).run(
        J.framework.Program.parse_from_string(data), feed={},
        fetch_list=FETCH, scope=jscope)
    tprog = tprogram.Program.parse_from_string(data)
    assert [op.type for op in tprog.global_block.ops] == \
        [o[0] for o in OPS]
    got = T.Executor(T.CPUPlace()).run(
        tprog, feed={}, fetch_list=FETCH,
        scope=scope_from_numpy(values, device="cpu"))
    for name, g, w in zip(FETCH, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_trace_op_matches_jax():
    values = _values()
    grads = []
    for pkg in (J, T):
        table = pkg.to_tensor(values["table"], stop_gradient=False)
        ids = pkg.to_tensor(values["ids"])
        out = pkg.to_tensor(np.zeros((3, 4, 4), "f4"))
        pkg.dygraph.eager.tracer().trace_op(
            "lookup_table", {"W": table, "Ids": ids}, {"Out": out},
            {"padding_idx": 0})
        w = pkg.to_tensor(np.arange(48, dtype="f4").reshape(3, 4, 4) / 48)
        (out * w).sum().backward()
        grads.append((np.asarray(out.numpy()), np.asarray(table.grad.numpy())))
    (jo, jg), (to, tg) = grads
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    assert (to[0, 0] == 0).all() and (tg[0] == 0).all()   # padding_idx 0


@pytest.mark.parametrize("name", ["norm", "unbind", "addmm"])
def test_calc_gradient_seeded_by_target_gradients_matches_jax(name):
    case = LINALG[name]
    prog, feed, fetch = tl._build("torch", case)
    outs = dict(zip(fetch, tl._run("torch", prog, feed, fetch)))
    rs = np.random.RandomState(1)
    cots = {n: rs.randn(*np.shape(outs[n])).astype("f4")
            for slot in case["grad"] for n in tl._out_names(case)[slot]}
    jprog, jfeed, jfetch = tl._build("jax", case, cots)
    want = dict(zip(jfetch, tl._run("jax", jprog, jfeed, jfetch)))
    blk = prog.global_block
    seeds = [blk.create_var(name=f"{n}@COT", shape=c.shape, dtype="float32")
             for n, c in cots.items()]
    ins = [blk.var(n) for n, a in feed.items() if a.dtype.kind == "f"]
    grads = calc_gradient([blk.var(n) for n in cots], ins, seeds)
    got = tl._run("torch", prog, {**feed, **{s.name: c for s, c in zip(
        seeds, cots.values())}}, [g.name for g in grads])
    for v, g in zip(ins, got):
        w = want[tprogram.grad_var_name(v.name)]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   err_msg=v.name, **TOL)
