"""A trainer of the port that ``tests/test_torch_multiprocess_elastic.py``
runs at three ranks, each under its elastic supervisor.

Started by the port's launcher with the fleet env contract and
``PADDLE_DISTRI_BACKEND=gloo`` on the CPU; it imports no JAX.  Arguments:
``<out> <kv endpoint>``.  Every rank publishes heartbeats to the test's
KV server (which serves ``/metrics/cluster``) for its whole life, and
runs two supervised runs of ``torch_dist_trainer.build_model`` on the
first ``ROWS`` rows of ``make_batch()``, a checkpoint every step, each
rank on its block of the rows:

- ``run1``: ``GradAllReduce`` at three ranks; rank 2 dies hard
  (``os._exit``) at the start of step 3.  Ranks 0 and 1 re-form the
  group at two, restore step 2 and finish ``STEPS`` steps.
- ``run2``: ZeRO-1 (``strategy.sharding``) at the two survivors; rank 1
  dies hard at step 3; rank 0 restores step 2 at one process, the
  velocities re-assembled from both ranks' blocks, and finishes.

Each rank writes ``<out>-<rank>-<run>.json``, and before it could die
``<out>-<rank>-<run>-blocks.npz`` (its velocities after step 2, what
the step-2 checkpoint holds of it); a survivor's rebuilt program writes
``-restored.npz``, what the restore put in its scope.  The module also
holds the functions the test hands to ``distributed.spawn``.
"""
import json
import os
import sys

import numpy as np

import torch_dist_trainer as W

ROWS, STEPS, KILL_STEP = 24, 5, 3
EXIT_CODE = 86          # a hard death's own exit code
HEARTBEAT_S = 0.5


def _strategy(**on):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy

    s = DistributedStrategy()
    for k, v in on.items():
        setattr(s, k, v)
    return s


def batches():
    X, Y = W.make_batch()
    return [(X[:ROWS], Y[:ROWS])] * STEPS


class Program:
    """A supervisor program over ``build_model`` at the topology's world:
    re-forms the group over its ranks, builds through ``fleet`` (whose
    ``fleet.init`` must see the new world), runs this rank's rows."""

    device = "cpu"

    def __init__(self, topo, job_rank, kv, sharding, dies, first, tag):
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.distributed import fleet, parallel_env
        from paddle_tpu_torch.distributed.fleet import elastic
        from paddle_tpu_torch.framework import unique_name

        parallel_env._join_survivors(
            topo.ranks, job_rank, kv, timeout_s=20.0,
            dead_ranks_fn=elastic.dead_ranks_from_cluster(kv))
        self.index, self.world = topo.ranks.index(job_rank), topo.world_size
        self.dies, self.first, self.tag = dies, first, tag
        with unique_name.guard():
            self.main, startup, self.loss, _ = W.build_model(
                pt, True, _strategy(sharding=sharding and self.world > 1))
        self.seen = {"topology": list(topo.ranks),
                     "worker_num": fleet.worker_num(),
                     "worker_index": fleet.worker_index(),
                     "role_worker_num": fleet._fleet_singleton._role_maker
                     ._worker_num(),
                     "parallel_env_world": parallel_env.ParallelEnv()
                     .world_size,
                     "group_world": parallel_env.get_world_size()}
        self.exe = pt.Executor(pt.CPUPlace())
        self.scope = pt.framework.Scope()
        self.exe.run(startup, scope=self.scope)
        self.velocities = sorted(
            n for op in self.main.global_block.ops if op.type == "momentum"
            for n in op.inputs.get("Velocity", ()))
        self.steps = 0

    def _save(self, what):
        np.savez(f"{self.tag}-{what}.npz", **{
            n: self.scope.get_var(n).numpy() for n in self.velocities})

    def step(self, batch):
        # the first program of a run starts at step 1; a rebuilt one at
        # the step after the restored checkpoint's
        if self.steps == 0 and not self.first:
            self._save("restored")
        self.steps += 1
        X, Y = batch
        if self.dies and self.first and self.steps == KILL_STEP:
            os._exit(EXIT_CODE)
        per = ROWS // self.world
        lo = self.index * per
        out = self.exe.run(self.main, feed={"x": X[lo:lo + per],
                                            "y": Y[lo:lo + per]},
                           fetch_list=[self.loss], scope=self.scope)
        if self.first and self.steps == KILL_STEP - 1:
            self._save("blocks")
        return float(np.asarray(out[0]).ravel()[0])

    def close(self):
        from paddle_tpu_torch.distributed import parallel_env

        self.exe.close()
        parallel_env.destroy_parallel_env()


def supervised(name, job_rank, kv, out, sharding, victim, world):
    """One supervised run from ``world`` ranks; ``victim`` dies hard."""
    from paddle_tpu_torch.ckpt import CheckpointManager, KVBarrier
    from paddle_tpu_torch.distributed.fleet import elastic

    ckpt = f"{out}-{name}-ckpt"
    seen = []

    def train_fn(topo):
        prog = Program(topo, job_rank, kv, sharding, job_rank == victim,
                       not seen, f"{out}-{job_rank}-{name}")
        seen.append(prog.seen)
        return prog

    def manager(topo):
        index, n = topo.ranks.index(job_rank), topo.world_size
        dead = elastic.dead_ranks_from_cluster(kv)
        barrier = KVBarrier(
            kv, index, n, timeout=60.0, prefix=f"{name}-w{n}",
            dead_ranks_fn=lambda: [topo.ranks.index(r) for r in dead()
                                   if r in topo.ranks])
        return CheckpointManager(ckpt, keep_n=0, async_save=False,
                                 rank=index, world_size=n, barrier=barrier)

    sup = elastic.ElasticSupervisor(
        world_size=world, cluster_url=kv, cluster_poll_s=0.0,
        save_every=1, preflight=False, backoff_s=0.2,
        postmortem_dir=f"{out}-{job_rank}-postmortem")
    r = sup.run(train_fn, manager=manager, loader=batches(),
                total_steps=STEPS)
    return r, {"result": {**r.to_dict(), "losses": r.losses},
               "builds": seen}


def wait_alive(kv, timeout_s=60.0):
    """Wait until the health plane has a beat of every rank: a rank not
    heard from yet reads as dead, and a supervisor polling then would
    re-shard a live job."""
    import time

    from paddle_tpu_torch.distributed.fleet import elastic

    dead, t0 = elastic.dead_ranks_from_cluster(kv), time.monotonic()
    while dead():
        if time.monotonic() - t0 > timeout_s:
            raise RuntimeError(f"ranks {dead()} never heartbeated")
        time.sleep(0.05)


def main():
    import torch

    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import parallel_env
    from paddle_tpu_torch.observe.health import HealthReporter

    out, kv = sys.argv[1], sys.argv[2]
    parallel_env.init_parallel_env()
    job_rank = parallel_env.get_rank()
    world = parallel_env.get_world_size()
    reporter = HealthReporter(kv, job_rank, world_size=world,
                              interval_s=HEARTBEAT_S).start()
    try:
        wait_alive(kv)
        r1, doc = supervised("run1", job_rank, kv, out, sharding=False,
                             victim=2, world=world)
        with open(f"{out}-{job_rank}-run1.json", "w") as f:
            json.dump(doc, f)
        # run 1's last program stays open, its compiled steps holding the
        # collectives of the two-rank group that run 2's death breaks: the
        # re-shard's close_all must drop them
        cached = len(r1.train.exe._cache)
        r2, doc = supervised("run2", job_rank, kv, out, sharding=True,
                             victim=1, world=r1.final_world_size)
        doc["run1_compiled_steps"] = [cached, len(r1.train.exe._cache)]
        with open(f"{out}-{job_rank}-run2.json", "w") as f:
            json.dump(doc, f)
        r1.train.close()
        r2.train.close()
    finally:
        reporter.stop()
        parallel_env.destroy_parallel_env()


# ---- distributed.spawn's functions (pickled by import path) ------------------

def spawn_probe(scale):
    """A rank of ``spawn``: an all-reduce of ``scale * (rank + 1)``; its
    rank, world size, backend and the sum."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import parallel_env

    x = torch.full((4,), float(scale * (parallel_env.get_rank() + 1)))
    dist.all_reduce(x)
    return {"rank": parallel_env.get_rank(),
            "world": parallel_env.get_world_size(),
            "backend": parallel_env.backend(), "sum": x.tolist()}


def spawn_fails_on_rank_1():
    """Rank 1 raises before the all-reduce rank 0 waits in."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import parallel_env

    if parallel_env.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(2))
    return "unreachable"


if __name__ == "__main__":
    main()
