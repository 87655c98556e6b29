"""PyTorch port: the six op types the builders emit that the port lowers
since the MoE/slim slice -- ``print``, ``auc``, ``cos_sim``,
``diag``/``diag_v2``, ``size`` and ``share_data`` (with ``memcpy``,
``memcpy_h2d``, ``memcpy_d2h``) -- against the JAX package's lowerings
on the CPU.

Each is a one-op program in both packages from the same numpy inputs
(``test_torch_rnn._program``; with cotangents, the generic gradient op
after it).  Tolerance 1e-6 relative for ``cos_sim`` and its gradients
(float32 sums over 7 terms in other orders); every other output is
exact: a copy, a rank statistic, an element count.  Types: the port's
``size`` is int64 and its ``auc`` float64, as the reference gives them;
the JAX package, with x64 off, returns int32 and float32, so values are
compared, not types.

``print`` writes ``message = value`` to stdout at each run, and a program
holding it runs eagerly (``capture_reason`` kind ``print``, counted
``executor_eager_print``), since a replayed graph would not print.
"""
import numpy as np
import pytest

import paddle_tpu_torch as T
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.monitor import stat_get
from test_torch_executor_graph import _RecordedStep
from test_torch_lowerings import _run
from test_torch_rnn import _program

RS = np.random.RandomState(0)
_X = RS.randn(5, 7).astype("f4")
_Y = RS.randn(5, 7).astype("f4")
_Y[2] = 0.0                       # a zero row: the 1e-12 clamp
_PRED = RS.rand(9, 2).astype("f4")
_PRED[3, 1] = _PRED[5, 1]         # a tie in the positive scores
_LABEL = np.array([1, 0, 1, 1, 0, 0, 1, 0, 1], "int64").reshape(-1, 1)

CASES = {
    "cos_sim": ("cos_sim", {"X": [_X], "Y": [_Y]},
                {"Out": 1, "XNorm": 1, "YNorm": 1}, {}, ("out",)),
    "auc": ("auc", {"Predict": [_PRED], "Label": [_LABEL]}, {"AUC": 1},
            {}, ()),
    "diag_vector": ("diag", {"X": [RS.randn(4).astype("f4")]}, {"Out": 1},
                    {"offset": 1, "padding_value": 0.0}, ()),
    "diag_v2_padding": ("diag_v2", {"X": [RS.randn(3).astype("f4")]},
                        {"Out": 1}, {"offset": -1, "padding_value": 2.5},
                        ()),
    "diag_v2_matrix": ("diag_v2", {"X": [RS.randn(4, 6).astype("f4")]},
                       {"Out": 1}, {"offset": 2}, ("out",)),
    "size": ("size", {"Input": [RS.randn(3, 4, 5).astype("f4")]},
             {"Out": 1}, {}, ()),
    "share_data": ("share_data", {"X": [_X]}, {"Out": 1}, {}, ("out",)),
    "memcpy": ("memcpy", {"X": [_X]}, {"Out": 1}, {"dst_place_type": 1},
               ()),
    "memcpy_h2d": ("memcpy_h2d", {"X": [_X]}, {"Out": 1},
                   {"dst_place_type": 1}, ()),
    "memcpy_d2h": ("memcpy_d2h", {"X": [_X]}, {"Out": 1},
                   {"dst_place_type": 0}, ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    op_type, inputs, outs, attrs, grad = CASES[case]
    prog, feed, fetch = _program("torch", op_type, inputs, outs, attrs)
    probe = dict(zip(fetch, _run("torch", prog, feed, fetch)))
    rs = np.random.RandomState(1)
    cots = {n: rs.randn(*np.shape(probe[n])).astype("f4") for n in fetch
            if n.split("_")[1] in grad}
    tp, tfeed, names = _program("torch", op_type, inputs, outs, attrs, cots)
    got = _run("torch", tp, tfeed, names)
    want = _run("jax", *_program("jax", op_type, inputs, outs, attrs, cots))
    assert len(got) == len(want) == len(names)
    for n, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, n
        if op_type == "cos_sim":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            assert np.array_equal(g.astype(np.float64),
                                  w.astype(np.float64)), n
    if op_type == "size":
        assert got[0].dtype == np.int64 and int(got[0]) == 60
    if op_type == "auc":
        assert got[0].dtype == np.float64 and 0.0 < got[0][0] < 1.0
    if cots:
        assert any(n.endswith("@GRAD") for n in names)


def _print_program():
    main, startup = tprogram.Program(), tprogram.Program()
    with T.framework.unique_name.guard(), \
            tprogram.program_guard(main, startup):
        x = T.layers.data("x", [3])
        blk = main.global_block
        out = blk.create_var(name="printed", shape=x.shape, dtype=x.dtype)
        blk.append_op("print", {"In": [x.name]}, {"Out": [out.name]},
                      {"message": "probe"})
        y = T.layers.scale(out, 2.0)
    return main, y


def test_print_prints_at_each_run_and_runs_eagerly(capsys, monkeypatch):
    """Through the capture path (a recording stand-in for the CUDA graph,
    ``exe._captures = True``) the program still runs its block at each
    step: three runs, three lines, no graph."""
    monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    main, y = _print_program()
    assert texecutor.capture_reason(main)[0] == "print"
    exe = T.Executor(T.CPUPlace())
    exe._captures = True
    n0 = stat_get("executor_eager_print")
    for i in range(3):
        x = np.full((1, 3), float(i), "f4")
        out = exe.run(main, feed={"x": x}, fetch_list=[y],
                      scope=T.framework.Scope())[0]
        np.testing.assert_array_equal(out, 2 * x)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("probe = ")]
    assert lines == [f"probe = [[{v}. {v}. {v}.]]" for v in range(3)]
    assert stat_get("executor_eager_print") - n0 == 3
    assert all(e.graph is None for e in exe._cache.values())
    # the graph-pass DCE keeps it although nothing reads its output
    from paddle_tpu_torch.framework.executor import _prune_ops

    kept = _prune_ops(main, ["x"], keep_side_effect_ops=True)
    assert "print" in [op.type for op in kept]
