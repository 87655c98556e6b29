"""PyTorch port: the elastic supervisor at three real processes over gloo
on the CPU, and ``distributed.spawn(nprocs=2)``.

The port's launcher starts three trainers of
``tests/torch_elastic_trainer.py`` once for the module; each runs under
its own ``ElasticSupervisor`` with a ``HealthReporter``, and this process
serves their KV server with ``serve_cluster_health`` at world size 3,
polling ``/metrics/cluster`` while they run.

- Run 1 (``GradAllReduce``, 24 rows, a checkpoint every step): rank 2
  dies hard at step 3; ranks 0 and 1 re-form the group at two, restore
  step 2 (the velocities the ranks held) and finish 5 steps, the losses
  within 1e-5 of the JAX package's one-process run on those rows.
- Run 2 (ZeRO-1, in the same processes, from the two survivors): rank 1
  dies hard at step 3; rank 0 restores at one process the velocities
  both ranks' blocks make, bit for bit, and its losses are within 1e-5
  of one process's.
- Every ``fleet.init`` after a re-join sees the new world; the re-shard
  closes every live executor, dropping compiled steps that call the dead
  group's collectives.
- ``/metrics/cluster`` saw three live ranks, then rank 2 dead, then
  ranks 1 and 2.
- ``spawn(nprocs=2)`` returns rank 0's result; a failing rank makes it
  raise naming that rank; NCCL on a machine without two cards raises
  naming gloo.
"""
import json
import os
import socket
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu as J
import torch_elastic_trainer as E
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet.utils import KVServer
from paddle_tpu_torch.distributed.launch import (start_local_trainers,
                                                 terminate_local_procs)
from paddle_tpu_torch.observe.health import serve_cluster_health

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ORACLE_RTOL = 1e-5
RANKS = 3
TIMEOUT_S = 150


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cluster_doc(kv):
    with urllib.request.urlopen(f"http://{kv}/metrics/cluster",
                                timeout=2) as r:
        return json.load(r)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_elastic_cluster")
    server = KVServer(0)
    serve_cluster_health(server, world_size=RANKS)
    server.start()
    kv = f"127.0.0.1:{server.port}"
    out = str(tmp / "out")
    env = {"PADDLE_DISTRI_BACKEND": "gloo", "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": ROOT + os.pathsep + HERE + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    procs, docs = [], []
    try:
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            procs = start_local_trainers(
                RANKS, f"127.0.0.1:{_free_port()}",
                os.path.join(HERE, "torch_elastic_trainer.py"), [out, kv],
                log_dir=str(tmp / "logs"))
        t0 = time.monotonic()
        while any(p.poll() is None for p in procs) and \
                time.monotonic() - t0 < TIMEOUT_S:
            try:
                docs.append(_cluster_doc(kv))
            except OSError:
                pass
            time.sleep(0.1)
        codes = [p.poll() for p in procs]
    finally:
        terminate_local_procs(procs)
        server.stop()
    # rank 0 finishes; ranks 1 and 2 die with their own code, each in its
    # run (rank 1 after writing run 1's results)
    if codes != [0, E.EXIT_CODE, E.EXIT_CODE] or not os.path.exists(
            f"{out}-1-run1.json"):
        logs = "".join(f"\n----- {f} -----\n" + open(
            os.path.join(tmp, "logs", f)).read()[-3000:]
            for f in sorted(os.listdir(tmp / "logs")))
        raise AssertionError(f"ranks exited {codes}{logs}")

    def doc(rank, run):
        with open(f"{out}-{rank}-{run}.json") as f:
            return json.load(f)

    def arrays(rank, run, what):
        return dict(np.load(f"{out}-{rank}-{run}-{what}.npz"))

    return {"doc": doc, "arrays": arrays, "cluster": docs}


def _jax_one_process():
    """The JAX package's one-process run on the same rows and steps."""
    import dist_trainer

    main, startup, loss = dist_trainer.build_model(use_fleet=False)
    X, Y = E.batches()[0]
    exe = J.Executor(J.CPUPlace())
    scope = J.framework.Scope()
    exe.run(startup, scope=scope)
    return [float(np.asarray(exe.run(
        main, feed={"x": X, "y": Y}, fetch_list=[loss],
        scope=scope)[0]).ravel()[0]) for _ in range(E.STEPS)]


def test_run1_survivors_rejoin_restore_and_match_one_process(cluster):
    oracle = _jax_one_process()
    runs = [cluster["doc"](r, "run1")["result"] for r in (0, 1)]
    for r in runs:
        assert r["status"] == "recovered" and r["reshards"] == 1
        assert r["final_world_size"] == 2 and r["restarts"] <= 2
        assert r["final_step"] == E.STEPS
        np.testing.assert_allclose(r["losses"], oracle, rtol=ORACLE_RTOL,
                                   atol=1e-7)
    assert runs[0]["losses"] == runs[1]["losses"]


def test_run1_restores_the_step_2_velocities(cluster):
    blocks = cluster["arrays"](0, "run1", "blocks")
    for rank in (0, 1):
        restored = cluster["arrays"](rank, "run1", "restored")
        assert sorted(restored) == sorted(blocks)
        for n in blocks:
            np.testing.assert_array_equal(restored[n], blocks[n],
                                          err_msg=n)


def test_run2_zero_reshards_to_one_with_the_blocks_bit_for_bit(cluster):
    r = cluster["doc"](0, "run2")["result"]
    assert r["status"] == "recovered" and r["reshards"] == 1
    assert r["final_world_size"] == 1 and r["restarts"] <= 2
    blocks = [cluster["arrays"](k, "run2", "blocks") for k in (0, 1)]
    restored = cluster["arrays"](0, "run2", "restored")
    assert restored and sorted(restored) == sorted(blocks[0])
    for n in restored:
        # each rank held half of every velocity (ZeRO-1's rows)
        assert blocks[0][n].shape[0] * 2 == restored[n].shape[0], n
        np.testing.assert_array_equal(
            restored[n], np.concatenate([blocks[0][n], blocks[1][n]]),
            err_msg=n)
    np.testing.assert_allclose(r["losses"], _jax_one_process(),
                               rtol=ORACLE_RTOL, atol=1e-7)


def test_a_reshard_drops_the_dead_groups_compiled_steps(cluster):
    """Run 1's last program stays open into run 2; rank 0's re-shard in
    run 2 closes every live executor (``close_all``): its compiled steps,
    which call the two-rank group's collectives, are gone."""
    before, after = cluster["doc"](0, "run2")["run1_compiled_steps"]
    assert before >= 1 and after == 0


def test_histories_record_the_death_and_the_reshard(cluster):
    for rank, run, dead in ((0, "run1", 2), (1, "run1", 2),
                            (0, "run2", 1)):
        hist = cluster["doc"](rank, run)["result"]["history"]
        kinds = [h["kind"] for h in hist]
        # the failed collective may read as transient first, while the
        # dead rank's heartbeat is still fresh; the topology change names
        # it from the health plane
        assert kinds[-1] == "topology_change", hist
        assert set(kinds) <= {"transient", "topology_change"}, hist
        assert hist[-1]["dead_ranks"] == [dead], hist
        assert hist[0]["step"] == E.KILL_STEP, hist


def test_fleet_init_after_a_rejoin_sees_the_new_world(cluster):
    worlds = []
    for rank, run in ((0, "run1"), (1, "run1"), (0, "run2")):
        for b in cluster["doc"](rank, run)["builds"]:
            n = len(b["topology"])
            assert b["worker_num"] == b["role_worker_num"] == n, b
            assert b["parallel_env_world"] == b["group_world"] == n, b
            assert b["worker_index"] == b["topology"].index(rank), b
            worlds.append(n)
    assert 2 in worlds and 1 in worlds and 3 in worlds


def test_cluster_plane_saw_three_ranks_then_the_dead(cluster):
    docs = cluster["cluster"]
    alive = next(i for i, d in enumerate(docs) if d["alive_ranks"] == 3)
    assert all(d["world_size"] == RANKS for d in docs)
    after = [d["dead_ranks"] for d in docs[alive:]]
    first2 = after.index([2])
    assert [1, 2] in after[first2:]
    assert all(float(e.get("step_time_p50_s") or 0) > 0
               for d in docs[alive + first2:] for r, e in
               d["ranks"].items() if r == "0" and e["alive"]
               and e.get("steps_timed"))


def test_spawn_returns_rank_0s_result():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLOO_SOCKET_IFNAME", "lo")
        mp.setenv("CUDA_VISIBLE_DEVICES", "")
        mp.delenv("PADDLE_DISTRI_BACKEND", raising=False)
        got = spawn(E.spawn_probe, args=(2.0,), nprocs=2)
    assert got == {"rank": 0, "world": 2, "backend": "gloo",
                   "sum": [6.0] * 4}


def test_spawn_names_the_failing_rank_and_refuses_nccl_without_cards():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLOO_SOCKET_IFNAME", "lo")
        mp.setenv("CUDA_VISIBLE_DEVICES", "")
        mp.delenv("PADDLE_DISTRI_BACKEND", raising=False)
        with pytest.raises(RuntimeError, match=r"rank 1 failed \(exit "
                           r"code 1\)") as e:
            spawn(E.spawn_fails_on_rank_1, nprocs=2)
        assert "rank 1 fails on purpose" in str(e.value)
        mp.setenv("PADDLE_DISTRI_BACKEND", "nccl")
        with pytest.raises(ValueError, match="gloo"):
            spawn(E.spawn_probe, args=(1.0,), nprocs=2)
