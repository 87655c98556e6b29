"""PyTorch port: the ten fake-quant lowerings of
``paddle_tpu_torch/ops/quant_ops.py``, held against the JAX package's
``paddle_tpu/ops/quant_ops.py`` on the CPU.

Each op runs as a one-op program in both packages from the same numpy
inputs (a seed).  Tolerance: none for the integer grids, the scales and
the moving-average state -- they are compared BIT FOR BIT.  Every step
there is exact in IEEE arithmetic given its inputs (an abs-max, a
correctly rounded division and multiplication, round half to even, a
clamp), and both packages perform the same steps in the same order; a
tolerance would hide a one-ulp difference before the rounding, which
moves a value by a whole quantization step.  The dequantized outputs
(``grid * scale / qmax``) are held to 2**-22 relative (two float32
ulps): XLA rewrites a division by a constant as a multiplication by its
reciprocal and refolds the constants, one rounding the port does not
take (it divides, so that the card and the CPU agree bit for bit).

Beside that: the straight-through gradient against ``jax.vjp`` of the
JAX lowering (the identity), an all-zero channel (its scale clamped on
its own, exact zeros out), the range op's ring buffer across a wrap of
its window (state carried in the scope step to step, in both packages),
a captured step against the eager block (the executor's capture path
through a recording stand-in for the CUDA graph), and the output dtype
of a bfloat16 input.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.framework import program as jprogram
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework.scope import to_numpy
from test_torch_executor_graph import _RecordedStep

PKG = {"jax": (J, jprogram), "torch": (T, tprogram)}
DEQUANT_RTOL = 2.0 ** -22


def _one_op(which, op_type, inputs, outs, attrs, persist=()):
    """A one-op program: ``inputs`` slot -> [(name, array)], ``outs`` slot
    -> [name].  Vars named in ``persist`` are persistable (state read from
    and written back to the scope)."""
    _pkg, prog_mod = PKG[which]
    prog = prog_mod.Program()
    blk = prog.global_block
    ins, made = {}, set()
    for slot, pairs in inputs.items():
        ins[slot] = []
        for name, a in pairs:
            if name not in made:
                blk.create_var(name=name, shape=list(a.shape),
                               dtype=a.dtype.name, stop_gradient=False,
                               persistable=name in persist)
                made.add(name)
            ins[slot].append(name)
    for names in outs.values():
        for n in names:
            if n not in made:
                blk.create_var(name=n, persistable=n in persist)
                made.add(n)
    blk.append_op(op_type, ins, {s: list(v) for s, v in outs.items()},
                  attrs)
    return prog


def _run(which, prog, feed, fetch, scope=None):
    pkg = PKG[which][0]
    exe = pkg.Executor(pkg.CPUPlace())
    out = exe.run(prog, feed=feed, fetch_list=fetch,
                  scope=scope if scope is not None else pkg.framework.Scope())
    return [np.asarray(o) for o in out]


def _x(rs, *shape):
    x = (rs.randn(*shape) * 3).astype("f4")
    x.flat[0] = 7.5           # a round number among the values
    return x


def _cases():
    rs = np.random.RandomState(0)
    x = _x(rs, 6, 8)
    w = _x(rs, 4, 3, 3, 3)
    w[1] = 0.0                # an all-zero output channel
    s1 = np.array([2.5], "f4")
    state = {"InScale": [("in_scale", s1)],
             "InState": [("in_state", np.array([3.0], "f4"))],
             "InAccum": [("in_accum", np.array([6.0], "f4"))]}
    ma_outs = {"Out": ["o"], "OutScale": ["o_scale"],
               "OutState": ["o_state"], "OutAccum": ["o_accum"]}
    q = np.clip(np.round(x / 7.5 * 127), -127, 127).astype("f4")
    return {
        "fake_quantize_abs_max": (
            {"X": [("x", x)]}, {"Out": ["o"], "OutScale": ["o_scale"]},
            {"bit_length": 8}),
        "fake_quantize_dequantize_abs_max": (
            {"X": [("x", x)]}, {"Out": ["o"], "OutScale": ["o_scale"]},
            {"bit_length": 4}),
        "fake_channel_wise_quantize_abs_max": (
            {"X": [("x", w)]}, {"Out": ["o"], "OutScale": ["o_scale"]},
            {"bit_length": 8, "quant_axis": 0}),
        "fake_channel_wise_quantize_dequantize_abs_max": (
            {"X": [("x", x)]}, {"Out": ["o"], "OutScale": ["o_scale"]},
            {"bit_length": 8, "quant_axis": 1}),
        "fake_quantize_moving_average_abs_max": (
            dict(X=[("x", x)], **state), ma_outs,
            {"bit_length": 8, "moving_rate": 0.9, "is_test": False}),
        "fake_quantize_dequantize_moving_average_abs_max": (
            dict(X=[("x", x)], **state), ma_outs,
            {"bit_length": 8, "moving_rate": 0.8, "is_test": False}),
        "fake_quantize_range_abs_max": (
            {"X": [("x", x)], "InScale": [("in_scale", s1)],
             "InScales": [("in_scales", np.array([1.0, 9.0, 2.0], "f4"))],
             "Iter": [("iter", np.array([4], "int64"))]},
            {"Out": ["o"], "OutScale": ["o_scale"],
             "OutScales": ["o_scales"], "OutIter": ["o_iter"]},
            {"bit_length": 8, "window_size": 3, "is_test": False}),
        "moving_average_abs_max_scale": (
            dict(X=[("x", x)], **state), ma_outs,
            {"moving_rate": 0.9, "is_test": False}),
        "fake_dequantize_max_abs": (
            {"X": [("x", q)], "Scale": [("s", np.array([7.5], "f4"))]},
            {"Out": ["o"]}, {"max_range": 127.0}),
        "fake_channel_wise_dequantize_max_abs": (
            {"X": [("x", q)],
             "Scales": [("s0", np.abs(rs.randn(8)).astype("f4") + 0.1),
                        ("s1", np.array([3.0], "f4"))]},
            {"Out": ["o"]}, {"quant_axis": 1, "quant_bits": [8, 4]}),
    }


CASES = _cases()


def _feed(inputs):
    return {n: a for pairs in inputs.values() for n, a in pairs}


def _fetch(outs):
    return [n for names in outs.values() for n in names]


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_lowering_is_bit_equal_to_jax(op_type):
    inputs, outs, attrs = CASES[op_type]
    got, want = (_run(w, _one_op(w, op_type, inputs, outs, attrs),
                      _feed(inputs), _fetch(outs)) for w in ("torch", "jax"))
    for name, g, w in zip(_fetch(outs), got, want):
        assert g.shape == w.shape, name
        if name == "o_iter":       # int64 in the port, int32 in JAX x64-off
            assert g.dtype == np.int64 and int(g[0]) == int(w[0]) == 5
            continue
        assert g.dtype == w.dtype, name
        if name == "o" and "dequantize" in op_type:
            np.testing.assert_allclose(g, w, rtol=DEQUANT_RTOL, atol=0)
            continue
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), \
            (name, np.abs(g - w).max())
    if op_type == "fake_quantize_abs_max":
        assert np.abs(got[0]).max() == 127.0 and got[1][0] == \
            np.abs(inputs["X"][0][1]).max()


@pytest.mark.parametrize("op_type", [
    "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max"])
def test_straight_through_gradient_matches_jax_vjp(op_type):
    """The port's generic gradient (the forward replayed under autograd)
    against ``jax.vjp`` of the JAX lowering: both the identity."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.framework.lowering import LoweringContext, get_lowering
    from paddle_tpu_torch.ops.grad_generic import lower_generic_grad

    inputs, outs, attrs = CASES[op_type]
    feed = _feed(inputs)
    rs = np.random.RandomState(3)
    cot = rs.randn(*feed["x"].shape).astype("f4")

    jop = _one_op("jax", op_type, inputs, outs, attrs).global_block.ops[0]

    def fwd(x):
        env = {n: jnp.asarray(a) for n, a in feed.items()}
        env["x"] = x
        get_lowering(op_type)(LoweringContext(jop.block, env), jop)
        return env["o"]

    _out, vjp = jax.vjp(fwd, jnp.asarray(feed["x"]))
    want = np.asarray(vjp(jnp.asarray(cot))[0])

    tprog = _one_op("torch", op_type, inputs, outs, attrs)
    top = tprog.global_block.ops[0]
    gop = tprogram.Operator(
        tprog.global_block, op_type + "_grad",
        inputs=dict({s: list(v) for s, v in top.inputs.items()},
                    Out=["o"], **{"Out@GRAD": ["o@GRAD"]}),
        outputs={"X@GRAD": ["x@GRAD"]},
        attrs=dict(top.attrs, __fwd_type__=op_type,
                   __fwd_out_slots__=["Out"]))
    env = {n: torch.from_numpy(a.copy()) for n, a in feed.items()}
    env["o"] = torch.zeros_like(env["x"])
    env["o@GRAD"] = torch.from_numpy(cot)
    from paddle_tpu_torch.framework.lowering import \
        LoweringContext as TCtx
    lower_generic_grad(TCtx(tprog.global_block, env,
                            torch.device("cpu")), gop)
    got = env["x@GRAD"].numpy()
    assert np.array_equal(got, want) and np.array_equal(got, cot)


def test_all_zero_channel_has_its_own_clamped_scale():
    from paddle_tpu_torch.ops.quant_ops import SCALE_EPS

    inputs, outs, attrs = CASES["fake_channel_wise_quantize_abs_max"]
    for op_type in ("fake_channel_wise_quantize_abs_max",
                    "fake_channel_wise_quantize_dequantize_abs_max"):
        a = dict(attrs, quant_axis=0)
        out, scale = _run("torch", _one_op("torch", op_type, inputs, outs,
                                           a), _feed(inputs), _fetch(outs))
        assert scale[1] == np.float32(SCALE_EPS) and (scale[[0, 2, 3]]
                                                      > 1e-3).all()
        assert np.isfinite(out).all() and not out[1].any()
        assert np.abs(out[0]).max() > 0


def _range_program(which, window):
    """x -> fake_quantize_range_abs_max with its scale, ring buffer and
    Iter persistable and wired in and out (the state a training program
    carries)."""
    x = np.zeros((4, 5), "f4")
    inputs = {"X": [("x", x)], "InScale": [("scale", np.zeros(1, "f4"))],
              "InScales": [("scales", np.zeros(window, "f4"))],
              "Iter": [("iter", np.zeros(1, "int64"))]}
    outs = {"Out": ["o"], "OutScale": ["scale"], "OutScales": ["scales"],
            "OutIter": ["iter"]}
    return _one_op(which, "fake_quantize_range_abs_max", inputs, outs,
                   {"bit_length": 8, "window_size": window,
                    "is_test": False},
                   persist=("scale", "scales", "iter"))


def test_range_ring_buffer_wraps_like_jax():
    """Window 3 over 7 steps whose abs-maxes fall, so the scale follows
    the window's max as old entries are overwritten (slot Iter % 3)."""
    window = 3
    rs = np.random.RandomState(5)
    peaks = [9.0, 4.0, 6.0, 2.0, 1.0, 3.0, 0.5]
    xs = []
    for p in peaks:
        x = rs.uniform(-0.4, 0.4, (4, 5)).astype("f4") * p
        x[0, 0] = p
        xs.append(x)
    init = {"scale": np.zeros(1, "f4"), "scales": np.zeros(window, "f4"),
            "iter": np.zeros(1, "int64")}
    results = {}
    for which in ("torch", "jax"):
        pkg = PKG[which][0]
        scope = pkg.framework.Scope()
        for n, a in init.items():
            scope.set_var(n, torch.from_numpy(a.copy()) if which == "torch"
                          else a.copy())
        prog = _range_program(which, window)
        results[which] = [_run(which, prog, {"x": x},
                               ["o", "scale", "scales", "iter"], scope)
                          for x in xs]
    for step, (g, w) in enumerate(zip(results["torch"], results["jax"])):
        for a, b in zip(g[:3], w[:3]):
            assert np.array_equal(a, b), step
        assert int(g[3][0]) == int(w[3][0]) == step + 1
        assert g[1][0] == max(peaks[max(0, step - window + 1):step + 1])


def _qat_program():
    main, startup = tprogram.Program(), tprogram.Program()
    with T.framework.unique_name.guard(), \
            tprogram.program_guard(main, startup):
        x = T.layers.data("x", [6])
        h = T.layers.fc(x, 5, act="relu")
        loss = T.layers.mean(T.layers.fc(h, 1))
        T.slim.quant_aware(main, startup)
        T.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def test_captured_step_equals_eager(monkeypatch):
    """A QAT program (weight qdq, moving-average activation qdq) over 5
    steps through the capture path (warm-up, capture, replays) and
    through the eager block, from one startup: losses and every state
    var (the moving averages written in place) bit-equal."""
    monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    main, startup, loss = _qat_program()
    assert sum(op.type.startswith("fake_") and not op.type.endswith(
        "_grad") for op in main.global_block.ops) == 4
    rs = np.random.RandomState(6)
    feeds = [{"x": rs.randn(4, 6).astype("f4")} for _ in range(5)]
    init_exe = T.Executor(T.CPUPlace())
    init = T.framework.Scope()
    init_exe.run(startup, scope=init)
    runs = {}
    for captured in (False, True):
        exe = T.Executor(T.CPUPlace())
        exe._captures = captured
        sc = T.framework.Scope()
        for n in init.local_var_names():
            if isinstance(init.get_var(n), torch.Tensor):
                sc.set_var(n, init.get_var(n).clone())
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=sc)[0].ravel()[0]) for f in feeds]
        assert [e.graph is not None for e in exe._cache.values()] == \
            [captured]
        runs[captured] = (losses, {n: to_numpy(sc.get_var(n)) for n in
                                   init.local_var_names() if isinstance(
                                       init.get_var(n), torch.Tensor)})
    assert runs[True][0] == runs[False][0]
    moved = 0
    for n, v in runs[False][1].items():
        assert np.array_equal(runs[True][1][n], v), n
        if "quant_scale" in n:
            moved += v[0] != 1.0
    assert moved == 2


def test_outputs_keep_the_input_dtype():
    x = torch.randn(4, 6).to(torch.bfloat16)
    for op_type in ("fake_quantize_abs_max",
                    "fake_quantize_dequantize_moving_average_abs_max",
                    "fake_channel_wise_quantize_dequantize_abs_max"):
        inputs, outs, attrs = CASES[op_type]
        prog = _one_op("torch", op_type, inputs, outs, attrs)
        feed = {n: torch.from_numpy(a) for n, a in _feed(inputs).items()}
        feed["x"] = x if "channel" not in op_type else x.reshape(4, 6)
        exe = T.Executor(T.CPUPlace())
        out = exe.run(prog, feed=feed, fetch_list=["o"],
                      scope=T.framework.Scope(), return_numpy=False)[0]
        assert out.dtype == torch.bfloat16, op_type
