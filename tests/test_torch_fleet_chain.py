"""PyTorch port: ``compile_strategy`` builds the JAX package's
meta-optimizer chain for each single-process strategy (the JAX package
at world size 1 on a one-device mesh), every refused strategy raises its
error (those waiting for several ranks name ROADMAP Queue A item 8; the
conflict and "needs a data-parallel degree > 1" errors keep the JAX
package's words), and the ``fleet`` facade works at one process.
"""
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import parallel_env as tenv
from torch_fleet_parity import build_both, fleet_minimize, net


def _strategy(fleet, **on):
    s = fleet.DistributedStrategy()
    for k, v in on.items():
        setattr(s, k, v)
    return s


CHAINS = {
    "amp_recompute": dict(amp=True, recompute=True,
                          recompute_configs={"checkpoints": ["H"]}),
    "gm_amp": dict(amp=True, gradient_merge=True,
                   gradient_merge_configs={"k_steps": 2}),
    "lars_fp16_allreduce": dict(lars=True, fp16_allreduce=True),
    "dgc_amp_recompute": dict(dgc=True, amp=True, recompute=True,
                              recompute_configs={"checkpoints": ["H"]}),
    "nothing": dict(),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_compile_strategy_builds_the_jax_chain(name):
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        compile_strategy as jcompile
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        chain_names, compile_strategy)

    def chain(p, compile_fn):
        main, startup, loss, h = net(p)
        cfg = dict(CHAINS[name])
        if "recompute_configs" in cfg:
            cfg["recompute_configs"] = {"checkpoints": [h.name]}
        fleet = jfleet if p is J else tfleet
        opt = p.optimizer.MomentumOptimizer(0.05, 0.9)
        return compile_fn(loss, None, opt, _strategy(fleet, **cfg))

    jchain, tchain = build_both(lambda p: chain(
        p, jcompile if p is J else compile_strategy))
    assert chain_names(tchain) == chain_names(jchain)


REFUSED = {
    # localsgd applies at one process; beside sharding, which needs a
    # degree above one, it wins the graph-level slot
    "localsgd": (dict(localsgd=True, sharding=True), ValueError,
                 "strategy.sharding=True could not be applied: it "
                 "conflicts with strategy.localsgd"),
    "pipeline": (dict(pipeline=True), NotImplementedError, "item 8"),
    "tensor_parallel": (dict(tensor_parallel=True), NotImplementedError,
                        "item 8"),
    "expert_parallel": (dict(expert_parallel=True), NotImplementedError,
                        "item 8"),
    "recompute_policy": (dict(recompute=True, recompute_configs={
        "checkpoints": ["x"], "policy": "bogus"}),
        ValueError, r"recompute_configs\['policy'\] must be one of"),
    "sharding": (dict(sharding=True), ValueError,
                 "strategy.sharding=True could not be applied: it needs a "
                 "data-parallel degree > 1"),
    "localsgd_and_pipeline": (dict(localsgd=True, pipeline=True),
                              ValueError, "conflicts with strategy.localsgd"),
    "a_sync": (dict(a_sync=True), NotImplementedError,
               "DistributedStrategy.a_sync is not implemented"),
    "sequence_parallel": (dict(sequence_parallel=True), NotImplementedError,
                          "DistributedStrategy.sequence_parallel is not "
                          "implemented"),
    "no_checkpoints": (dict(recompute=True), ValueError, "checkpoints"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_strategies_raise(name):
    on, err, match = REFUSED[name]
    main, startup, loss, _ = net(T)
    with pytest.raises(err, match=match):
        fleet_minimize(T, main, startup, loss,
                       T.optimizer.MomentumOptimizer(0.05, 0.9),
                       _strategy(tfleet, **on))


def test_fleet_facade_at_one_process(monkeypatch):
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "10.0.0.1:1,10.0.0.2:2")
    tenv.reset_mesh()
    s = tfleet.DistributedStrategy()
    assert tfleet.init(is_collective=True, strategy=s) is not None
    assert (tfleet.worker_index(), tfleet.worker_num(),
            tfleet.is_first_worker(), tfleet.is_worker(),
            tfleet.is_server()) == (0, 1, True, True, False)
    assert tfleet.worker_endpoints(to_string=True) == "10.0.0.1:1,10.0.0.2:2"
    assert tfleet.barrier_worker() is None
    assert tfleet.init_worker() is None and tfleet.stop_worker() is None
    assert tfleet._fleet_singleton.distributed_strategy is s
    assert tenv.get_mesh() is None
    assert tfleet.elastic.chaos is not None
    with pytest.raises(AttributeError, match="item 8"):
        tfleet.distributed_embedding
    fresh = tfleet.Fleet()
    fresh.init()
    main, startup, loss, _ = net(T)
    with pytest.raises(RuntimeError, match="distributed_optimizer"):
        fresh.minimize(loss)
