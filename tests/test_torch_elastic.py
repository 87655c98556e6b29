"""PyTorch port: ``fleet.elastic``'s supervisor, held to the JAX package's
(``tests/test_elastic.py``).

- ``TestSupervisor``'s cases on the port's ``CheckpointManager``: the
  plain run, the chaos rank kill and its re-shard, the shrunken topology
  ``train_fn`` sees, the poison step, the restart budget, dead-rank
  detection from the cluster plane, the watchdog stall, the torn
  checkpoint, no manager, a stateless program, the caller's fault hook
  chained and restored, and the classification table.
- The JAX and port supervisors on one toy program under the same chaos
  injections give the same ``SupervisorResult.to_dict()`` and losses
  (timestamps, bundle paths and the rate left out).
- ``classify_failure`` / ``is_device_failure`` agree with the JAX
  package's on its table and its markers; the card's markers (CUDA, out
  of memory, NCCL, gloo losing a peer) read as device failures.
- The acceptance test: a chaos rank kill mid-step 5 of a two-rank run
  re-shards to one and continues through the port's executor, manager
  and ``DataLoader``, bit for bit the uninterrupted run's losses and
  state.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.ckpt import CheckpointManager as JCheckpointManager
from paddle_tpu.distributed.fleet import elastic as jelastic
import paddle_tpu_torch as pt
from paddle_tpu_torch.ckpt import CheckpointManager
from paddle_tpu_torch.distributed.fleet import elastic
from paddle_tpu_torch.distributed.fleet.elastic import chaos
from paddle_tpu_torch.framework.scope import Scope
from paddle_tpu_torch.monitor import stat_get


@pytest.fixture(autouse=True)
def _chaos_and_postmortem(tmp_path):
    """Disarmed armories (both packages') and a postmortem directory of
    the test's own; fsync off (throwaway directories)."""
    chaos.clear()
    jelastic.chaos.clear()
    flags = ["FLAGS_postmortem_dir", "FLAGS_ckpt_fsync"]
    old, jold = pt.get_flags(flags), J.get_flags(flags)
    new = {"FLAGS_postmortem_dir": str(tmp_path / "postmortem"),
           "FLAGS_ckpt_fsync": False}
    pt.set_flags(new)
    J.set_flags({**new,
                 "FLAGS_postmortem_dir": str(tmp_path / "jpostmortem")})
    yield
    chaos.clear()
    jelastic.chaos.clear()
    pt.set_flags(old)
    J.set_flags(jold)


class _Toy:
    """``tests/test_elastic.py``'s toy: the state is one float summing the
    batches, checkpointed through ``state()`` / ``load_state()``; its
    restore goes to the CPU."""

    device = "cpu"

    def __init__(self):
        self.w = 0.0

    def step(self, batch):
        self.w += float(batch)
        return self.w

    def state(self):
        return {"w": np.asarray([self.w], dtype="f8")}

    def load_state(self, state):
        self.w = float(np.asarray(state["w"]).ravel()[0])


class _JToy(_Toy):
    """The same toy for the JAX supervisor (host arrays back)."""

    device = None


_BATCHES = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
_CUMSUM = [1.0, 3.0, 6.0, 10.0, 15.0, 21.0]


def _sup(**kw):
    kw.setdefault("preflight", False)
    kw.setdefault("backoff_s", 0.0)
    return elastic.ElasticSupervisor(**kw)


def _mgr(tmp_path, name="c"):
    return CheckpointManager(str(tmp_path / name), keep_n=0,
                             async_save=False)


class TestSupervisor:
    def test_plain_run_ok(self, tmp_path):
        mgr = _mgr(tmp_path)
        r = _sup(world_size=1).run(lambda topo: _Toy(), manager=mgr,
                                   loader=_BATCHES, total_steps=6)
        mgr.close()
        assert r.status == "ok" and r.restarts == 0 and r.reshards == 0
        assert r.losses == _CUMSUM and r.final_step == 6

    def test_kill_rank_reshards_and_resumes(self, tmp_path):
        mgr = _mgr(tmp_path)
        chaos.inject("kill_rank_mid_step", rank=1, at_step=4)
        r = _sup(world_size=2).run(lambda topo: _Toy(), manager=mgr,
                                   loader=_BATCHES, total_steps=6)
        mgr.close()
        assert r.status == "recovered"
        assert r.restarts == 1 and r.reshards == 1
        assert r.final_world_size == 1
        assert r.losses == _CUMSUM
        h = r.history[0]
        assert h["kind"] == "topology_change" and h["step"] == 4
        assert h["dead_ranks"] == [1]
        bundles = os.listdir(tmp_path / "postmortem")
        assert any("elastic_topology_change" in b for b in bundles)

    def test_train_fn_sees_shrunken_topology(self, tmp_path):
        worlds = []

        def train_fn(topo):
            worlds.append((topo.world_size, tuple(topo.ranks)))
            return _Toy()

        mgr = _mgr(tmp_path)
        chaos.inject("kill_rank_mid_step", rank=1, at_step=2)
        _sup(world_size=3).run(train_fn, manager=mgr, loader=_BATCHES,
                               total_steps=4)
        mgr.close()
        assert worlds == [(3, (0, 1, 2)), (2, (0, 2))]

    def test_poison_step_terminates_loudly(self, tmp_path):
        class Bad(_Toy):
            def step(self, batch):
                if float(batch) == 3.0:
                    raise ValueError("deterministic step bug")
                return super().step(batch)

        mgr = _mgr(tmp_path)
        with pytest.raises(elastic.ElasticTerminated,
                           match="poison") as ei:
            _sup(world_size=1, max_restarts=10).run(
                lambda topo: Bad(), manager=mgr, loader=_BATCHES,
                total_steps=6)
        mgr.close()
        assert len(ei.value.history) == 2
        assert all(h["step"] == 3 for h in ei.value.history)

    def test_restart_budget_exhaustion_is_terminal_not_a_hang(self):
        n = [0]

        def train_fn(topo):
            n[0] += 1

            def step(i, batch):
                raise RuntimeError(f"flaky device episode {n[0]}")

            return step

        with pytest.raises(elastic.ElasticTerminated,
                           match="budget") as ei:
            _sup(world_size=1, max_restarts=2).run(
                train_fn, total_steps=3)
        assert len(ei.value.history) == 3

    def test_dead_rank_detection_from_cluster_plane(self, tmp_path):
        seen = {"steps": 0}

        class Counting(_Toy):
            def step(self, batch):
                seen["steps"] += 1
                return super().step(batch)

        def cluster_fn():
            return {"dead_ranks": [1] if seen["steps"] >= 2 else []}

        mgr = _mgr(tmp_path)
        r = _sup(world_size=2, cluster_fn=cluster_fn,
                 cluster_poll_s=0.0).run(
            lambda topo: Counting(), manager=mgr, loader=_BATCHES,
            total_steps=5)
        mgr.close()
        assert r.reshards == 1 and r.final_world_size == 1
        assert r.history[0]["kind"] == "topology_change"
        assert r.history[0]["dead_ranks"] == [1]
        assert r.losses == _CUMSUM[:5]

    def test_watchdog_stall_dumps_bundle_and_restarts_in_place(
            self, tmp_path):
        mgr = _mgr(tmp_path)
        chaos.inject("hang_device_call", at_step=3, seconds=0.7)
        r = _sup(world_size=1, watchdog_timeout_s=0.15).run(
            lambda topo: _Toy(), manager=mgr, loader=_BATCHES,
            total_steps=5)
        mgr.close()
        assert r.status == "recovered" and r.restarts == 1
        assert r.reshards == 0
        assert r.history[0]["kind"] == "transient"
        assert "StallDetected" in r.history[0]["error"]
        assert r.losses == _CUMSUM[:5]
        bundles = os.listdir(tmp_path / "postmortem")
        assert any(b.startswith("bundle_") and "stall" in b
                   for b in bundles)

    def test_torn_checkpoint_falls_back_and_recovers(self, tmp_path):
        mgr = _mgr(tmp_path)
        chaos.inject("torn_checkpoint", at_step=4)
        r = _sup(world_size=1).run(lambda topo: _Toy(), manager=mgr,
                                   loader=_BATCHES, total_steps=6)
        assert r.status == "recovered" and r.restarts == 1
        assert "TornCheckpoint" in r.history[0]["error"]
        assert r.losses == _CUMSUM
        assert mgr.latest_intact_step() == 6
        mgr.close()

    def test_no_manager_runs_unsupervised_checkpointing(self):
        r = _sup(world_size=1).run(lambda topo: _Toy(),
                                   loader=_BATCHES, total_steps=4)
        assert r.losses == _CUMSUM[:4] and r.status == "ok"

    def test_stateless_program_with_manager_skips_saves(self, tmp_path):
        mgr = _mgr(tmp_path)
        r = _sup(world_size=1).run(
            lambda topo: (lambda i, batch: float(batch)),
            manager=mgr, loader=_BATCHES, total_steps=3)
        assert r.losses == _BATCHES[:3] and r.status == "ok"
        assert mgr.all_steps() == []
        mgr.close()

    def test_caller_fault_hook_chained_and_restored(self, tmp_path):
        mgr = _mgr(tmp_path)
        phases = []

        def user_hook(phase, step):
            phases.append((phase, step))

        mgr.set_fault_hook(user_hook)
        r = _sup(world_size=1).run(lambda topo: _Toy(), manager=mgr,
                                   loader=_BATCHES, total_steps=2)
        assert r.status == "ok"
        assert ("pre_commit", 1) in phases
        assert mgr._fault_hook is user_hook
        mgr.close()

    def test_classify_failure_table(self):
        assert elastic.classify_failure(
            chaos.RankKilled(2)) == "topology_change"
        assert elastic.classify_failure(
            RuntimeError("x"), dead_ranks=[1]) == "topology_change"
        assert elastic.classify_failure(
            RuntimeError("x")) == "transient"
        assert elastic.classify_failure(
            RuntimeError("x"), repeat=True) == "poison_step"
        from paddle_tpu_torch.observe.xla_stats import MemoryBudgetError

        # a budget refusal is poison even on its first occurrence
        assert elastic.classify_failure(
            MemoryBudgetError("too big")) == "poison_step"
        assert elastic.is_device_failure(RuntimeError(
            "RESOURCE_EXHAUSTED: out of memory".lower()))
        assert not elastic.is_device_failure(KeyError("shape"))


# ---------------------------------------------------------------------------
# the two packages' supervisors side by side
# ---------------------------------------------------------------------------


def _comparable(result):
    """``to_dict()`` without what differs from run to run: the steps'
    rate, each failure's timestamp and bundle path."""
    d = dict(result.to_dict())
    d.pop("steps_per_sec")
    d["history"] = [{k: v for k, v in h.items()
                     if k not in ("ts", "postmortem")}
                    for h in d["history"]]
    return d


def _both(tmp_path, inject, world_size, total_steps=6, program=None,
          **sup_kw):
    """One scenario under either package's supervisor, manager, toy and
    chaos armory: their comparable results and losses."""
    out = []
    for name, el, mgr_cls, toy in (
            ("jax", jelastic, JCheckpointManager, _JToy),
            ("torch", elastic, CheckpointManager, _Toy)):
        for fault, params in inject:
            el.chaos.inject(fault, **params)
        kw = dict(sup_kw)
        if "cluster_fn" in kw:
            kw["cluster_fn"] = kw["cluster_fn"]()
        mgr = mgr_cls(str(tmp_path / name), keep_n=0, async_save=False)
        sup = el.ElasticSupervisor(preflight=False, backoff_s=0.0,
                                   world_size=world_size, **kw)
        r = sup.run(lambda topo: (program or toy)(), manager=mgr,
                    loader=_BATCHES, total_steps=total_steps)
        mgr.close()
        out.append((_comparable(r), r.losses))
    return out


def _dead_after_two():
    seen = {"polls": 0}

    def fn():
        seen["polls"] += 1
        return {"dead_ranks": [1] if seen["polls"] > 2 else []}

    return fn


@pytest.mark.parametrize("scenario", [
    ("plain", [], 1, {}),
    ("kill_rank", [("kill_rank_mid_step", {"rank": 1, "at_step": 4})], 2,
     {}),
    ("kill_rank_world3", [("kill_rank_mid_step",
                           {"rank": 1, "at_step": 2})], 3, {}),
    ("torn", [("torn_checkpoint", {"at_step": 4})], 1, {}),
    ("dead_rank", [], 2, {"cluster_fn": _dead_after_two,
                          "cluster_poll_s": 0.0}),
], ids=lambda s: s[0])
def test_supervisor_results_equal_the_jax_packages(tmp_path, scenario):
    _, inject, world, kw = scenario
    (jd, jl), (td, tl) = _both(tmp_path, inject, world, **kw)
    assert td == jd
    assert tl == jl == _CUMSUM


def test_poison_and_budget_histories_equal_the_jax_packages(tmp_path):
    """The terminal paths: the same histories and messages' kind."""
    class Bad(_Toy):
        def step(self, batch):
            if float(batch) == 3.0:
                raise ValueError("deterministic step bug")
            return super().step(batch)

    def flaky(el):
        n = [0]

        def train_fn(topo):
            n[0] += 1

            def step(i, batch):
                raise RuntimeError(f"flaky device episode {n[0]}")
            return step
        return train_fn

    got = []
    for el, mgr_cls in ((jelastic, JCheckpointManager),
                        (elastic, CheckpointManager)):
        mgr = mgr_cls(str(tmp_path / el.__name__), keep_n=0,
                      async_save=False)
        with pytest.raises(el.ElasticTerminated, match="poison") as p:
            el.ElasticSupervisor(preflight=False, backoff_s=0.0,
                                 max_restarts=10).run(
                lambda topo: Bad(), manager=mgr, loader=_BATCHES,
                total_steps=6)
        mgr.close()
        with pytest.raises(el.ElasticTerminated, match="budget") as b:
            el.ElasticSupervisor(preflight=False, backoff_s=0.0,
                                 max_restarts=2).run(flaky(el),
                                                     total_steps=3)
        got.append([[{k: v for k, v in h.items()
                      if k not in ("ts", "postmortem")}
                     for h in e.value.history] for e in (p, b)])
    assert got[0] == got[1]


def test_classification_agrees_with_the_jax_package():
    """Each package's own exception types and the JAX markers, through
    both ``classify_failure`` and ``is_device_failure``."""
    from paddle_tpu.distributed.fleet.elastic import supervisor as jsup
    from paddle_tpu.observe.xla_stats import MemoryBudgetError as JBudget

    from paddle_tpu_torch.observe.xla_stats import MemoryBudgetError

    def table(el, budget):
        excs = [el.chaos.RankKilled(2), el.DeadRankDetected([1, 0]),
                el.StallDetected(3), RuntimeError("x"), KeyError("shape"),
                budget("too big"), el.chaos.TornCheckpoint("torn")]
        excs += [RuntimeError(f"step failed: {m} gone")
                 for m in jsup._DEVICE_MARKERS]
        rows = []
        for e in excs:
            rows.append((type(e).__name__, el.is_device_failure(e),
                         el.classify_failure(e),
                         el.classify_failure(e, dead_ranks=[1]),
                         el.classify_failure(e, repeat=True)))
        return rows

    assert table(elastic, MemoryBudgetError) == table(jelastic, JBudget)


def test_card_and_collective_markers_read_as_device_failures():
    """CUDA errors, the allocator's out of memory, NCCL and gloo losing a
    peer read as the device failing; one occurrence is transient."""
    for exc in (
            RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"),
            torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                        "allocate 2.00 GiB"),
            RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1970, "
                         "unhandled system error"),
            RuntimeError("[third_party/gloo/gloo/transport/tcp/pair.cc:553]"
                         " Connection closed by peer [127.0.0.1]:35243"),
            RuntimeError("[tcp/pair.cc:598] Connection reset by peer")):
        assert elastic.is_device_failure(exc), exc
        assert elastic.classify_failure(exc) == "transient"
    assert not elastic.is_device_failure(KeyError("Moment1"))


# ---------------------------------------------------------------------------
# the acceptance test on the port's executor, manager and DataLoader
# ---------------------------------------------------------------------------


def _full_train_fn():
    """``tests/test_torch_ckpt_resume._build_full_model`` (fc -> dropout
    -> fc, Momentum under StepDecay and float16 dynamic loss scaling) as
    a supervisor program, built afresh at every (re)start."""
    from test_torch_ckpt_resume import _build_full_model

    def train_fn(topo):
        main, startup, loss, sched = _build_full_model()
        sc = Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=sc)

        class Prog:
            scope = sc
            device = "cpu"
            components = {"lr_sched": sched}

            def step(self, batch):
                bx, by = batch
                out = exe.run(main, feed={"x": bx, "y": by},
                              fetch_list=[loss], scope=sc)
                sched.step()
                return float(np.asarray(out[0]).ravel()[0])

            def params(self):
                return {n: sc.get_var(n) for n in sc.local_var_names()
                        if isinstance(sc.get_var(n), torch.Tensor)}

        return Prog()

    return train_fn


def _full_loader():
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    rs = np.random.RandomState(0)
    X = rs.randn(32, 8).astype("f4")
    Y = (X.sum(1, keepdims=True) * 0.3).astype("f4")
    return DataLoader(TensorDataset([X, Y]), batch_size=8, shuffle=False)


def test_chaos_rank_kill_reshards_bitwise(tmp_path):
    """Chaos kills rank 1 mid-step 5 of a two-rank run: topology_change,
    a re-shard to world 1, the latest intact async checkpoint restored,
    the iterator fast-forwarded; losses and the final state (parameters,
    momentum slots, the LR step, the generator, the loss-scale counters)
    bit for bit the uninterrupted run's."""
    mo = CheckpointManager(str(tmp_path / "oracle"), keep_n=0,
                           async_save=True)
    ro = _sup(world_size=1).run(_full_train_fn(), manager=mo,
                                loader=_full_loader(), total_steps=7)
    mo.close()
    assert ro.status == "ok" and len(ro.losses) == 7
    oracle_params = ro.train.params()

    chaos.inject("kill_rank_mid_step", rank=1, at_step=5)
    mc = CheckpointManager(str(tmp_path / "chaos"), keep_n=0,
                           async_save=True)
    before = stat_get("elastic_reshards")
    rc = _sup(world_size=2).run(_full_train_fn(), manager=mc,
                                loader=_full_loader(), total_steps=7)
    mc.close()
    assert rc.status == "recovered"
    assert rc.restarts == 1 and rc.reshards == 1
    assert rc.final_world_size == 1
    assert stat_get("elastic_reshards") == before + 1
    assert rc.history[0]["kind"] == "topology_change"

    np.testing.assert_array_equal(rc.losses, ro.losses)
    chaos_params = rc.train.params()
    assert sorted(chaos_params) == sorted(oracle_params)
    for n in oracle_params:
        assert torch.equal(chaos_params[n], oracle_params[n]), n
