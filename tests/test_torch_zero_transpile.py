"""PyTorch port: ZeRO-1's rewrite and LocalSGD's average program, in one
process, against the JAX package.

- ``ShardingMetaOptimizer`` (through ``compile_strategy`` at a data-
  parallel degree of 2, patched into both packages' meta-optimizer
  base) on the strategy-test network with a 3-wide hidden layer (one
  param whose dim 0 divides by 2, two that stay replicated) equals the
  JAX rewrite op for op: types, slots and attrs, the
  ``__sharded_accumulators__`` stamps included; over AdamW, Adam,
  Momentum and Lamb, with ``fp16_allreduce`` and ``gradient_merge`` on
  and off.  The chain's class names agree too.
- No param with a divisible dim 0 raises the JAX package's ValueError.
- ``LocalSGD``'s average program equals the JAX one op for op; at one
  process ``strategy.localsgd`` applies (its average is the identity)
  and ``run_steps`` refuses the program with the JAX package's words.
- ``executor._cut_zero_blocks`` at rank 1 of 2 keeps the second half of
  each sharded accumulator and records its origin.

Two real ranks: ``tests/test_torch_multiprocess_zero.py``.
"""
from importlib import import_module

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
import paddle_tpu.distributed.fleet.meta_optimizers as jmeta
import paddle_tpu_torch.distributed.fleet.meta_optimizers as tmeta
import torch_layer_scan_models as M
from paddle_tpu_torch.framework import executor as texecutor
from torch_fleet_parity import build_both, data, net

OPTIMIZERS = {
    "adamw": lambda p: p.optimizer.AdamWOptimizer(0.01, weight_decay=0.01),
    "adam": lambda p: p.optimizer.AdamOptimizer(0.01),
    "momentum": lambda p: p.optimizer.MomentumOptimizer(0.05, 0.9),
    "lamb": lambda p: p.optimizer.LambOptimizer(0.01),
}


@pytest.fixture
def two_ranks(monkeypatch):
    for m in (jmeta, tmeta):
        monkeypatch.setattr(m.MetaOptimizerBase, "_nranks", lambda self: 2)


def _fleet_program(p, opt, hidden=3, **on):
    fleet = import_module(p.__name__ + ".distributed.fleet")
    metas = import_module(p.__name__ + ".distributed.fleet.meta_optimizers")
    main, startup, loss, _ = net(p, hidden=hidden)
    s = fleet.DistributedStrategy()
    for k, v in on.items():
        setattr(s, k, v)
    with p.framework.program_guard(main, startup):
        chain = metas.compile_strategy(loss, None, OPTIMIZERS[opt](p), s)
        chain.minimize(loss)
    return main, startup, loss, tmeta.chain_names(chain)


@pytest.mark.parametrize("gm", [False, True])
@pytest.mark.parametrize("fp16", [False, True])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sharding_rewrite_equals_the_jax_one(two_ranks, opt, fp16, gm):
    on = dict(sharding=True, fp16_allreduce=fp16)
    if gm:
        on.update(gradient_merge=True,
                  gradient_merge_configs={"k_steps": 2})
    (jmain, _, _, jchain), (tmain, _, _, tchain) = build_both(
        lambda p: _fleet_program(p, opt, **on))
    assert tchain == jchain and tchain[0] == "ShardingMetaOptimizer"
    ours = M.op_list(tmain)
    assert ours == M.op_list(jmain)
    types = [op[0] for op in ours]
    # the 8x3 weight is sharded; the 3x3 and 3x1 stay replicated
    assert types.count("c_reducescatter") == 1
    assert types.count("c_allreduce_sum") == 2
    assert types.count("c_shard_slice") == types.count("c_allgather") == 1
    stamped = [op[3]["__sharded_accumulators__"] for op in ours
               if "__sharded_accumulators__" in op[3]]
    assert len(stamped) == 1
    want = {"adamw": 2, "adam": 2, "lamb": 2, "momentum": 1}[opt] + int(gm)
    assert len(stamped[0]) == want
    assert texecutor.zero_accumulators(tmain) == tuple(stamped[0])


def test_no_divisible_param_raises_the_jax_error(two_ranks):
    for p in (J, T):
        fleet = import_module(p.__name__ + ".distributed.fleet")
        metas = import_module(p.__name__ +
                              ".distributed.fleet.meta_optimizers")
        unique = import_module(p.__name__ + ".framework.unique_name")
        with unique.guard():
            main, startup, loss, _ = net(p, x_dim=3, hidden=5)
            # 3x5, 5x5 and 5x1: no dim 0 divides by 2
            s = fleet.DistributedStrategy()
            s.sharding = True
            with p.framework.program_guard(main, startup):
                chain = metas.compile_strategy(
                    loss, None, OPTIMIZERS["adam"](p), s)
                with pytest.raises(ValueError,
                                   match="no parameter has dim0 divisible"):
                    chain.minimize(loss)


def test_localsgd_average_program_equals_the_jax_one():
    from paddle_tpu.distributed.fleet.collective_transpiler import (
        LocalSGD as JLocalSGD)
    from paddle_tpu_torch.distributed.fleet.collective_transpiler import (
        LocalSGD as TLocalSGD)

    (jmain, *_), (tmain, *_) = build_both(
        lambda p: _fleet_program(p, "momentum", hidden=16))
    javg = JLocalSGD(2, k_steps=3).build_average_program(jmain)
    tavg = TLocalSGD(2, k_steps=3).build_average_program(tmain)
    assert M.op_list(tavg) == M.op_list(javg)
    assert [op[0] for op in M.op_list(tavg)] == \
        ["c_allreduce_sum", "scale"] * 3


def test_localsgd_at_one_process_applies_and_run_steps_refuses():
    main, startup, loss, chain = _fleet_program(
        T, "momentum", hidden=16, localsgd=True,
        localsgd_configs={"k_steps": 2})
    assert chain[0] == "LocalSGDMetaOptimizer"
    avg = main._localsgd
    assert (avg.nranks, avg.k_steps) == (1, 2)
    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(startup, scope=scope)
    feed = data()
    for _ in range(4):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert avg._step == 4
    with pytest.raises(NotImplementedError,
                       match="run_steps does not support localsgd"):
        exe.run_steps(main, feed=feed, fetch_list=[loss], scope=scope,
                      steps=2)


def test_cut_zero_blocks_keeps_this_ranks_rows(two_ranks, monkeypatch):
    from paddle_tpu_torch.distributed import parallel_env

    main, startup, _, _ = _fleet_program(T, "adam", hidden=3,
                                         sharding=True)
    scope = T.framework.Scope()
    T.Executor(T.CPUPlace()).run(startup, scope=scope)
    accs = texecutor.zero_accumulators(main)
    full = {}
    for n in accs:
        v = np.arange(np.prod(scope.get_var(n).shape), dtype="f4")
        full[n] = v.reshape(tuple(scope.get_var(n).shape))
        scope.set_var(n, full[n])
    monkeypatch.setattr(parallel_env, "get_world_size", lambda: 2)
    monkeypatch.setattr(parallel_env, "get_rank", lambda: 1)
    texecutor._cut_zero_blocks(main, scope)
    texecutor._cut_zero_blocks(main, scope)   # a block is left alone
    for n in accs:
        half = full[n].shape[0] // 2
        np.testing.assert_array_equal(scope.get_var(n).numpy(),
                                      full[n][half:])
        assert scope.zero_blocks[n] == (full[n].shape, (half, 0))
