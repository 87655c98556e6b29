"""PyTorch port: the single-process meta-optimizers through ``fleet``
against the JAX package (world size 1), on the CPU, from the JAX
startup's values: amp (bf16, and fp16 with dynamic loss scaling through
gradient merge's grad-transform route), recompute, gradient merge (k = 2
equals one step on the double batch; parameters and optimizer state
frozen between updates, eager and captured), LARS, LAMB and DGC.

Tolerances: float32 programs within 1e-5 relative (other summation
orders).  The bf16 programs run the JAX side without XLA's excess
precision (``torch_fleet_parity.run_jax_exact``), so both packages round
every bfloat16 value the program declares: within rtol 1e-4, atol 1e-6,
the JAX package's own bound for its amp + recompute chain.  fp16 with
loss scaling: within 1e-3 relative (float16 products, 10-bit mantissas).
Gradient merge's frozen steps and its captured run are checked bit for
bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_fleet_parity import (build_both, data, run_both, run_jax_exact,
                                run_port, strategy_net)

RTOL = 1e-5


def _compare(build, steps=4, rtol=RTOL, atol=0.0, feeds=None):
    (jm, js, jf), (tm, ts, tf) = build_both(build)
    assert sorted(op.type for op in tm.global_block.ops) == \
        sorted(op.type for op in jm.global_block.ops)
    feeds = feeds or [data(seed=s) for s in range(steps)]
    want, got, jscope, tscope = run_both((jm, js), (tm, ts), feeds, tf)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=rtol, atol=atol)
    return tm, jscope, tscope, [float(g[0].ravel()[0]) for g in got]


def _exact(tmp_path, rtol, atol, steps=6, **kwargs):
    feeds = [data(seed=s) for s in range(steps)]
    init, want = run_jax_exact("torch_fleet_parity:strategy_net", kwargs,
                               feeds, tmp_path)
    tm, ts, tf = build_both(lambda p: strategy_net(p, **kwargs))[1]
    got, _ = run_port((tm, ts), init, feeds, tf)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=rtol, atol=atol)
    return tm, [float(g[0].ravel()[0]) for g in got]


def test_amp_bf16_matches_jax(tmp_path):
    tm, losses = _exact(tmp_path, 1e-4, 1e-6, amp=True)
    assert "cast" in [op.type for op in tm.global_block.ops]
    assert min(losses[1:]) < losses[0]


def test_recompute_matches_jax_and_the_plain_program():
    tm, _, _, losses = _compare(lambda p: strategy_net(
        p, ckpt=True, recompute=True))
    assert "recompute_barrier" in [op.type for op in tm.global_block.ops]
    _, _, _, plain = _compare(lambda p: strategy_net(p))
    assert losses == plain


def _gm(k, **on):
    return dict(gradient_merge=True,
                gradient_merge_configs={"k_steps": k, "avg": True}, **on)


def test_gradient_merge_k2_equals_the_double_batch_and_jax():
    full = data(seed=0, n=32)
    halves = [{k: v[:16] for k, v in full.items()},
              {k: v[16:] for k, v in full.items()}]
    _, jscope, tscope, _ = _compare(lambda p: strategy_net(p, **_gm(2)),
                                    feeds=halves)
    jparts, tparts = build_both(lambda p: strategy_net(p))
    _, _, _, once = run_both(jparts[:2], tparts[:2], [full], tparts[2])
    for n in ("fc_0.w_0", "fc_1.w_0", "fc_2.w_0"):
        np.testing.assert_allclose(tscope.get_var(n).numpy(),
                                   once.get_var(n).numpy(),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(tscope.get_var(n).numpy(),
                                   np.asarray(jscope.get_var(n)),
                                   rtol=RTOL, atol=1e-6)


def _frozen_run(captured, monkeypatch, k=3, steps=7):
    """Parameters and velocities after each step under gradient merge k,
    through the executor's eager block or its capture path."""
    from paddle_tpu_torch.framework import executor as texecutor
    from paddle_tpu_torch.framework.scope import scope_from_numpy
    from test_torch_executor_graph import _RecordedStep

    monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    (jm, js, _), (tm, ts, tf) = build_both(
        lambda p: strategy_net(p, **_gm(k)))
    jscope = J.framework.Scope()
    J.Executor(J.CPUPlace()).run(js, scope=jscope)
    scope = scope_from_numpy(
        {v.name: np.asarray(jscope.get_var(v.name))
         for v in js.global_block.vars.values() if v.persistable},
        device="cpu")
    exe = T.Executor(T.CPUPlace())
    exe._captures = captured
    state = [n for n in scope.local_var_names()
             if n.startswith("fc_") and "gm_acc" not in n]
    out = []
    for s in range(steps):
        exe.run(tm, feed=data(seed=s), fetch_list=tf, scope=scope)
        exe.drain()
        out.append({n: scope.get_var(n).clone() for n in state})
    exe.close()
    return out, state


def test_gradient_merge_freezes_state_between_updates(monkeypatch):
    (eager, state), (captured, _) = (_frozen_run(c, monkeypatch)
                                     for c in (False, True))
    assert any("velocity" in n for n in state)
    for s in range(7):
        for n in state:
            # captured and eager agree bit for bit
            assert torch.equal(eager[s][n], captured[s][n]), (s, n)
        if s % 3 != 2 and s > 0:   # only the 3rd and 6th steps update
            for n in state:
                assert torch.equal(eager[s][n], eager[s - 1][n]), (s, n)
    for s in (2, 5):
        assert not torch.equal(eager[s]["fc_0.w_0"], eager[s - 1]["fc_0.w_0"])


def test_fp16_amp_through_gradient_merge_matches_jax():
    tm, _, _, _ = _compare(lambda p: strategy_net(p, **_gm(
        2, amp=True, amp_configs={"use_bf16": False,
                                  "init_loss_scaling": 128.0})),
        steps=4, rtol=1e-3, atol=1e-5)
    ops = [op.type for op in tm.global_block.ops]
    assert "check_finite_and_unscale" in ops and "update_loss_scaling" in ops


SWAPS = {
    "lars": ("momentum", dict(lars=True, lars_configs={
        "lars_coeff": 0.01, "lars_weight_decay": 0.001}), "lars_momentum"),
    "lamb": ("adam", dict(lamb=True,
                          lamb_configs={"lamb_weight_decay": 0.01}), "lamb"),
    "dgc": ("sgd", dict(dgc=True, dgc_configs={"sparsity": [0.75]}), "dgc"),
}


@pytest.mark.parametrize("name", sorted(SWAPS))
def test_swapping_and_compressing_optimizers_match_jax(name):
    opt, on, op_type = SWAPS[name]
    tm, jscope, tscope, _ = _compare(
        lambda p: strategy_net(p, opt=opt, **on), steps=4)
    assert op_type in [op.type for op in tm.global_block.ops]
    for v in tm.global_block.vars.values():
        if v.persistable and jscope.has_var(v.name):
            np.testing.assert_allclose(
                tscope.get_var(v.name).numpy(),
                np.asarray(jscope.get_var(v.name)), rtol=RTOL, atol=1e-6)
