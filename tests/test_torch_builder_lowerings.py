"""PyTorch port: every op the port's builders emit has a lowering
(``recompute_barrier``, ``clip_by_norm``, ``ema_update``,
``lars_momentum``, ``ftrl``, ``dpsgd``, ``print``, ``auc``, ``cos_sim``,
``diag``, ``size``, ``share_data``, ``moe_ffn``, ``while`` and
``cond_pair`` among them), each matching the JAX package's on the CPU.

- The walk: every op type named in the source of ``layers``,
  ``optimizer/static_opt.py``, ``framework/backward.py``, ``amp``,
  ``fluid/io.py`` and ``distributed`` (a string literal, or an f-string's
  constant prefix, that is an op type of the JAX package) lowers in the
  port or is a host I/O op; ``LATER``, the list of op types waiting for
  a ROADMAP item, is empty.
- Each program is built in both packages and run from the JAX startup's
  values: fetches within 1e-5 relative (float32 both sides, other
  summation orders); the recompute program's gradients also within 1e-6
  of the same program built without checkpoints (the port: the same
  values, bit for bit, on the CPU).
- ``dpsgd``'s noise comes from the program's ``torch.Generator``: its
  clipped step matches the JAX package's with ``sigma`` 0, and the noise
  has mean 0 and deviation ``clip * sigma / batch_size`` within 5
  standard errors.
"""
import ast
import os

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_fleet_parity import build_both, data, net, run_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5

# op types the port's builders can emit that wait for a later slice, with
# the ROADMAP Queue A item each waits for
LATER = {}

BUILDERS = ["layers.py", "optimizer/static_opt.py", "framework/backward.py",
            "fluid/io.py", "amp", "distributed"]


def _builder_files():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    for b in BUILDERS:
        path = os.path.join(pkg, b)
        if b.endswith(".py"):
            yield path
            continue
        for d, _, fs in os.walk(path):
            yield from (os.path.join(d, f) for f in fs if f.endswith(".py"))


def _emitted_types():
    import paddle_tpu.framework.lowering as jl
    from paddle_tpu_torch.framework.executor import HOST_OPS

    universe = set(jl.LOWERINGS) | HOST_OPS
    found = set()
    for path in _builder_files():
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Constant) and node.value in universe:
                found.add(node.value)
            elif isinstance(node, ast.JoinedStr) and node.values \
                    and isinstance(node.values[0], ast.Constant):
                prefix = node.values[0].value
                if len(prefix) >= 3:
                    found |= {t for t in universe if t.startswith(prefix)}
    return found


def test_every_emitted_op_type_lowers_or_is_named_later():
    from paddle_tpu_torch.framework.executor import HOST_OPS
    from paddle_tpu_torch.framework.lowering import get_lowering

    found = _emitted_types()
    missing = []
    for t in sorted(found - HOST_OPS):
        try:
            get_lowering(t)
        except NotImplementedError:
            missing.append(t)
    assert len(found) > 140
    assert sorted(set(missing) - set(LATER)) == []
    # the later list names only what is still missing
    assert sorted(LATER) == missing
    for t in ("recompute_barrier", "clip_by_norm", "ema_update",
              "lars_momentum", "ftrl", "dpsgd", "c_allreduce_sum", "dgc",
              "print", "auc", "cos_sim", "diag", "size", "share_data",
              "moe_ffn", "while", "cond_pair"):
        assert t in found and get_lowering(t) is not None


def _mlp(p, emit):
    """x [6] -> fc 5 tanh -> fc 3 -> softmax cross entropy; ``emit(p,
    loss, h)`` adds the op under test and returns the fetches."""
    main, startup = p.framework.Program(), p.framework.Program()
    main.random_seed = 5
    with p.framework.program_guard(main, startup):
        x = p.layers.data("x", [6])
        y = p.layers.data("y", [1], dtype="int64")
        h = p.layers.fc(x, 5, act="tanh")
        loss = p.layers.mean(p.layers.softmax_with_cross_entropy(
            p.layers.fc(h, 3), y))
        fetch = emit(p, loss, h)
    return main, startup, fetch


def _feeds(n=3, seed=2):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(8, 6).astype("f4"),
             "y": rng.randint(0, 3, (8, 1)).astype("int64")}
            for _ in range(n)]


def _assert_steps(want, got, rtol=RTOL, atol=0.0):
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def test_recompute_barrier_is_the_identity():
    def emit(p, loss, h):
        block = h.block
        out = block.create_var(name="h_bar", shape=h.shape, dtype=h.dtype)
        block.append_op("recompute_barrier", {"X": [h.name]},
                        {"Out": [out.name]})
        return [h, out]

    (jm, js, jf), (tm, ts, tf) = build_both(lambda p: _mlp(p, emit))
    want, got, _, _ = run_both((jm, js), (tm, ts), _feeds(1), tf)
    np.testing.assert_array_equal(got[0][1], got[0][0])
    _assert_steps(want, got)


def _grad_names(p, loss, checkpoints):
    from importlib import import_module

    bw = import_module(p.__name__ + ".framework.backward")
    pgs = bw.append_backward(loss, checkpoints=checkpoints)
    return [g for _, g in pgs]


def _recompute_net(p, with_checkpoints):
    main, startup, loss, h = net(p)
    with p.framework.program_guard(main, startup):
        grads = _grad_names(p, loss, [h.name] if with_checkpoints else None)
    return main, startup, [loss] + grads


def test_recompute_gradients_match_jax_and_the_plain_program():
    (jm, js, jf), (tm, ts, tf) = build_both(
        lambda p: _recompute_net(p, True))
    ops = [op.type for op in tm.global_block.ops]
    assert "recompute_barrier" in ops
    assert sorted(ops) == sorted(op.type for op in jm.global_block.ops)
    want, got, _, _ = run_both((jm, js), (tm, ts), [data()], tf)
    _assert_steps(want, got, atol=1e-7)
    plain = build_both(lambda p: _recompute_net(p, False))[1]
    _, base, _, _ = run_both((jm, js), plain[:2], [data()], plain[2])
    _assert_steps(base, got, rtol=0, atol=1e-6)


def test_recompute_segments_sit_just_before_their_gradients():
    """Each re-emitted op comes after the forward's last op and before
    the first gradient op that reads it, and the last segment is rebuilt
    first (the port's order; the JAX package emits them all at the
    backward's start)."""
    from paddle_tpu_torch.framework.backward import RECOMPUTE_SUFFIX

    tm = build_both(lambda p: _recompute_net(p, True))[1][0]
    ops = tm.global_block.ops
    seed = next(i for i, op in enumerate(ops) if op.type == "fill_constant"
                and any(n.endswith("@GRAD") for n in op.output_arg_names()))
    rc = [i for i, op in enumerate(ops)
          if any(n.endswith(RECOMPUTE_SUFFIX) for n in op.output_arg_names())]
    assert rc and min(rc) > seed
    read = 0
    for i in rc:
        made = set(ops[i].output_arg_names())
        first = next((j for j, op in enumerate(ops)
                      if made & set(op.input_arg_names())), None)
        if first is not None:   # (a value no gradient reads: left at the end)
            assert first > i
            read += 1
    assert read >= len(rc) // 2
    # the head (after the checkpoint) is rebuilt before the first layer
    first_grad = next(i for i, op in enumerate(ops)
                      if op.type.endswith("_grad"))
    assert min(rc) < first_grad < max(rc)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_norm_matches_jax(max_norm):
    def emit(p, loss, h):
        return [h, p.layers.clip_by_norm(h, max_norm=max_norm)]

    (jm, js, jf), (tm, ts, tf) = build_both(lambda p: _mlp(p, emit))
    want, got, _, _ = run_both((jm, js), (tm, ts), _feeds(1), tf)
    _assert_steps(want, got)
    norm = np.linalg.norm(got[0][1])
    assert norm == pytest.approx(min(max_norm, np.linalg.norm(got[0][0])),
                                 rel=1e-5)


@pytest.mark.parametrize("thres_steps", [None, 1])
def test_ema_update_matches_jax(thres_steps):
    shadows = {}

    def emit(p, loss, h):
        p.optimizer.SGDOptimizer(0.5).minimize(loss)
        ema = p.optimizer.ExponentialMovingAverage(
            0.9, thres_steps=thres_steps)
        ema.update()
        shadows[p.__name__] = sorted(ema._shadows.values())
        return [loss] + shadows[p.__name__]

    (jm, js, jf), (tm, ts, tf) = build_both(lambda p: _mlp(p, emit))
    assert shadows["paddle_tpu"] == shadows["paddle_tpu_torch"]
    assert "ema_update" in [op.type for op in tm.global_block.ops]
    want, got, _, _ = run_both((jm, js), (tm, ts), _feeds(3), tf)
    _assert_steps(want, got, atol=1e-7)


OPTIMIZERS = {
    "lars_momentum": lambda p: p.optimizer.LarsMomentumOptimizer(
        0.1, momentum=0.9, lars_coeff=0.01, lars_weight_decay=0.001),
    "ftrl": lambda p: p.optimizer.FtrlOptimizer(0.1, l1=0.01, l2=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_programs_match_jax(name):
    def emit(p, loss, h):
        OPTIMIZERS[name](p).minimize(loss)
        return [loss]

    (jm, js, jf), (tm, ts, tf) = build_both(lambda p: _mlp(p, emit))
    assert name in [op.type for op in tm.global_block.ops]
    want, got, jscope, tscope = run_both((jm, js), (tm, ts), _feeds(3), tf)
    _assert_steps(want, got)
    for v in js.global_block.vars.values():
        if v.persistable:
            np.testing.assert_allclose(
                tscope.get_var(v.name).numpy(),
                np.asarray(jscope.get_var(v.name)), rtol=RTOL, atol=1e-6)


def _dpsgd(p, sigma, width):
    main, startup = p.framework.Program(), p.framework.Program()
    with p.framework.program_guard(main, startup):
        x = p.layers.data("x", [width])
        loss = p.layers.mean(p.layers.fc(x, 1, bias_attr=False))
        p.optimizer.DpsgdOptimizer(learning_rate=1.0, clip=0.5,
                                   batch_size=8.0, sigma=sigma).minimize(loss)
    return main, startup, [loss, "fc_0.w_0"]


def test_dpsgd_clips_as_jax_and_draws_its_noise_from_the_generator():
    width, clip, sigma, batch = 4096, 0.5, 2.0, 8.0
    x = np.random.RandomState(0).randn(8, width).astype("f4")
    (jm, js, _), (tm, ts, tf) = build_both(lambda p: _dpsgd(p, 0.0, width))
    want, got, _, _ = run_both((jm, js), (tm, ts), [{"x": x}], tf)
    _assert_steps(want, got, atol=1e-8)

    (jm, js, _), (tm, ts, tf) = build_both(lambda p: _dpsgd(p, sigma, width))
    assert "dpsgd" in [op.type for op in tm.global_block.ops]
    zero = {"fc_0.w_0": np.zeros((width, 1), "f4")}
    _, got, _, _ = run_both((jm, js), (tm, ts), [{"x": x}], tf,
                            init_override=zero)
    # from w = 0 (lr 1): w' = -(clipped gradient + noise); the gradient of
    # mean(x @ w) is x's column mean
    g = x.astype(np.float64).mean(0)
    g *= min(1.0, clip / np.linalg.norm(g))
    noise = -got[0][1].ravel() - g
    std = clip * sigma / batch
    assert abs(noise.mean()) < 5 * std / np.sqrt(width)
    assert abs(noise.std() - std) < 5 * std / np.sqrt(2 * width)
