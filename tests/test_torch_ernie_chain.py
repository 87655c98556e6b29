"""PyTorch port: the fleet slice end to end at a small size -- BASELINE
config 5's ERNIE finetune (``torch_ernie_models``: 2 layers, hidden 32,
vocab 64, seq 16, batch 8) through ``fleet.distributed_optimizer`` with
amp (bf16) + recompute checkpointed at every layer's ``_ln2``.

- Against the JAX package (world size 1): the programs hold the same ops,
  with casts and recompute barriers and no ``c_allreduce_*``; 6 steps'
  losses from the JAX startup's values within rtol 1e-4, atol 1e-6 (the
  JAX package's own bound for this chain, ``test_ernie_chain.py``), the
  JAX side run without XLA's excess precision so that both round every
  bfloat16 value the program declares (``torch_fleet_parity``).
- In the port: amp + recompute equals amp alone bit for bit (the same
  ops on the same values; one thread, since the CPU's embedding gradient
  sums in a thread-dependent order), while the eager block's peak of live
  tensor bytes falls.
- With dropout 0.1, the captured path (a recorded stand-in for the CUDA
  graph) equals the eager block bit for bit and the loss falls on a
  repeated batch; amp + gradient merge (k 4) keeps every parameter
  bit-equal on the steps that do not update.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
import torch_ernie_models as E
from torch_fleet_parity import build_both, run_jax_exact, run_port

TOL = dict(rtol=1e-4, atol=1e-6)
FEEDS = [E.feed(E.SMALL, seed=s) for s in range(6)]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_chain_builds_the_jax_program():
    (jm, _, _), (tm, _, _) = build_both(lambda p: E.parts(p))
    ops = [op.type for op in tm.global_block.ops]
    assert sorted(ops) == sorted(op.type for op in jm.global_block.ops)
    assert "cast" in ops and ops.count("recompute_barrier") > 10
    assert ops.count("fused_multihead_attention") == 2 * E.SMALL["layers"]
    for prog in (jm, tm):
        assert not [op for op in prog.global_block.ops
                    if op.type.startswith("c_allreduce")]
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        chain_names

    assert chain_names(fleet._fleet_singleton.applied_chain) == [
        "RecomputeMetaOptimizer", "AMPMetaOptimizer", "AdamWOptimizer"]


def test_amp_recompute_losses_match_jax(tmp_path):
    init, want = run_jax_exact("torch_ernie_models:parts", {}, FEEDS,
                               tmp_path)
    tparts = build_both(lambda p: E.parts(p))[1]
    got, _ = run_port(tparts, init, FEEDS, tparts[2])
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               **TOL)


def _live_peak(main, startup, loss, feeds):
    """Losses and the most tensor bytes alive at once in the eager
    block's environment over the run."""
    from paddle_tpu_torch.framework import executor as ex

    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(startup, scope=scope)
    peak = [0]
    real = ex.get_lowering

    def counted(op_type):
        rule = real(op_type)

        def run(ctx, op):
            rule(ctx, op)
            seen = {}
            for v in ctx.env.values():
                if isinstance(v, torch.Tensor):
                    s = v.untyped_storage()
                    seen[s.data_ptr()] = s.nbytes()
            peak[0] = max(peak[0], sum(seen.values()))
        return run

    ex.get_lowering = counted
    try:
        losses = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0]).ravel()[0])
            for f in feeds]
    finally:
        ex.get_lowering = real
    return losses, peak[0]


def test_recompute_changes_no_number_and_lowers_the_peak(one_thread):
    wider = dict(batch=16, seq=64, max_pos=66, hidden=64, ffn=256, layers=4)
    feeds = [E.feed(dict(E.SMALL, **wider), seed=s) for s in range(3)]
    runs = {}
    for rc in (False, True):
        main, startup, fetch = build_both(
            lambda p: E.parts(p, recompute=rc, **wider))[1]
        runs[rc] = _live_peak(main, startup, fetch[0], feeds)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] < 0.8 * runs[False][1], runs


def _steps(captured, monkeypatch, parts, feeds, watch=()):
    from paddle_tpu_torch.framework import executor as texecutor
    from test_torch_executor_graph import _RecordedStep

    monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    main, startup, fetch = parts
    exe = T.Executor(T.CPUPlace())
    exe._captures = captured
    scope = T.framework.Scope()
    exe.run(startup, scope=scope)
    losses, states = [], []
    for f in feeds:
        out = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(out[0]).ravel()[0]))
        states.append({n: scope.get_var(n).clone() for n in watch})
    exe.close()
    return losses, states


def test_captured_chain_with_dropout_equals_eager_and_trains(
        monkeypatch, one_thread):
    parts = build_both(lambda p: E.parts(p, dropout=0.1))[1]
    feeds = [FEEDS[0]] * 10
    eager, _ = _steps(False, monkeypatch, parts, feeds)
    captured, _ = _steps(True, monkeypatch, parts, feeds)
    assert captured == eager
    assert all(np.isfinite(eager)) and eager[-1] < eager[0]


def test_gradient_merge_chain_freezes_parameters(monkeypatch, one_thread):
    parts = build_both(lambda p: E.parts(p, recompute=False,
                                         gradient_merge=4))[1]
    params = [p.name for p in parts[0].all_parameters()]
    runs = [_steps(c, monkeypatch, parts, FEEDS + FEEDS[:2], params)
            for c in (False, True)]
    (eager, states), (captured, cstates) = runs
    assert captured == eager
    for s in range(8):
        for n in params:
            assert torch.equal(states[s][n], cstates[s][n])
            if s % 4 != 3 and s > 0:
                assert torch.equal(states[s][n], states[s - 1][n]), (s, n)
    assert not torch.equal(states[3][params[0]], states[2][params[0]])
