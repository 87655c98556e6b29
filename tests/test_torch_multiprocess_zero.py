"""PyTorch port: ZeRO-1, LocalSGD and a several-process checkpoint at two
real ranks over gloo on the CPU.

The port's launcher starts two trainers of ``tests/torch_zero_trainer.py``
(the cluster is started once for the module); the one-process runs they
are held to run here.

- ZeRO-1 (``strategy.sharding``) on the JAX oracle's network
  (``tests/dist_trainer.build_model``), 5 steps: both ranks fetch the
  same losses, within 1e-5 of the JAX package's one-process run
  (``test_two_process_zero_sharding_parity``'s oracle); each rank holds
  its half of every sharded accumulator, and a fetch of one is the full
  value, all-gathered.
- On the small BERT, ZeRO-1 and ``GradAllReduce`` give the same losses
  and parameters bit for bit: the gradients are the same sums and AdamW
  is elementwise.
- LocalSGD at ``k_steps`` 2: finite, decreasing losses; the main
  program holds no collective (``capture_reason`` None) and only the
  averages run eagerly for one; after each average the ranks'
  parameters are the numpy mean of their values before it, bit for
  bit, and after a step in between they differ.
- ``save_sharded`` from both ranks after 3 ZeRO steps, then
  ``load_sharded`` here at one process: the velocities are the ranks'
  blocks concatenated, bit for bit, and step 4 on the full batch gives
  the ranks' step-4 loss within 1e-5.
- ``strategy.localsgd`` with two ranks in one process raises.
"""
import json
import os
import socket

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
import torch_dist_trainer as W
import torch_zero_trainer as Z
from paddle_tpu_torch.distributed.launch import (start_local_trainers,
                                                 terminate_local_procs,
                                                 watch_local_trainers)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ORACLE_RTOL = 1e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_zero_cluster")
    main, startup, _ = W.bert_program(J)
    scope = J.framework.Scope()
    J.Executor(J.CPUPlace()).run(startup, scope=scope)
    np.savez(str(tmp / "init.npz"), **{
        v.name: np.asarray(scope.get_var(v.name))
        for v in startup.global_block.vars.values()
        if v.persistable and scope.has_var(v.name)})
    env = {"PADDLE_DISTRI_BACKEND": "gloo", "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": ROOT + os.pathsep + HERE + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = str(tmp / "out")
    procs = []
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        try:
            procs = start_local_trainers(
                2, f"127.0.0.1:{_free_port()}",
                os.path.join(HERE, "torch_zero_trainer.py"),
                [out, str(tmp / "init.npz")], log_dir=str(tmp / "logs"))
            rc = watch_local_trainers(procs)
        finally:
            terminate_local_procs(procs)
    if rc != 0:
        logs = "".join(f"\n----- {f} -----\n" + open(
            os.path.join(tmp, "logs", f)).read()[-3000:]
            for f in sorted(os.listdir(tmp / "logs")))
        raise AssertionError(f"cluster exited rc={rc}{logs}")
    return [json.load(open(f"{out}-{r}.json")) for r in range(2)], out


def _jax_one_process(steps=5):
    import dist_trainer

    main, startup, loss = dist_trainer.build_model(use_fleet=False)
    X, Y = dist_trainer.make_batch()
    exe = J.Executor(J.CPUPlace())
    scope = J.framework.Scope()
    exe.run(startup, scope=scope)
    return [float(np.asarray(exe.run(
        main, feed={"x": X, "y": Y}, fetch_list=[loss],
        scope=scope)[0]).ravel()[0]) for _ in range(steps)]


def test_zero_matches_the_jax_package_at_one_process(cluster):
    results, _ = cluster
    a, b = (r["zero"] for r in results)
    assert [r["nranks"] for r in results] == [2, 2]
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"], _jax_one_process(),
                               rtol=ORACLE_RTOL, atol=1e-6)
    for t in ("c_reducescatter", "c_shard_slice", "c_allgather"):
        assert t in a["ops"]


def test_each_rank_holds_half_of_each_sharded_accumulator(cluster):
    results, _ = cluster
    for rank, r in enumerate(results):
        z = r["zero"]
        assert z["held"] and sorted(z["held"]) == sorted(z["declared"])
        for n, shape in z["held"].items():
            full = z["declared"][n]
            assert shape == [full[0] // 2] + full[1:], n
            assert z["blocks"][n] == rank * full[0] // 2


def test_a_fetched_sharded_accumulator_is_all_gathered(cluster):
    results, _ = cluster
    a, b = (r["zero"] for r in results)
    full = np.concatenate([np.asarray(a["local_acc"]),
                           np.asarray(b["local_acc"])])
    np.testing.assert_array_equal(np.asarray(a["fetched_acc"]), full)
    assert a["fetched_acc"] == b["fetched_acc"]


def test_zero_equals_grad_allreduce_bit_for_bit(cluster):
    results, _ = cluster
    for r in results:
        assert r["bert"]["zero"] == r["bert"]["allreduce"]
        assert all(np.isfinite(r["bert"]["zero"]["losses"]))
    assert results[0]["bert"] == results[1]["bert"]


def test_localsgd_losses_are_finite_and_decrease(cluster):
    results, _ = cluster
    for r in results:
        ls = r["localsgd"]["losses"]
        assert len(ls) == Z.LOCALSGD_STEPS and np.isfinite(ls).all()
        assert ls[-1] < ls[0], ls
        # the main program holds no collective (it would be captured on
        # the card), and only the averages ran eagerly for a collective:
        # the allreduce and the 1/n scale of every parameter
        assert not any(t.startswith("c_") for t in r["localsgd"]["ops"])
        assert r["localsgd"]["capture_reason"] is None
        assert r["localsgd"]["eager_host_collective"] == \
            Z.LOCALSGD_STEPS // Z.LOCALSGD_K
        assert set(r["localsgd"]["avg_ops"]) == {"c_allreduce_sum", "scale"}


def test_localsgd_averages_are_the_ranks_mean(cluster):
    results, _ = cluster
    a, b = (r["localsgd"]["steps"] for r in results)
    assert [s["averaged"] for s in a] == [False, True] * (
        Z.LOCALSGD_STEPS // 2)
    for sa, sb in zip(a, b):
        names = sorted(sa["before"])
        if not sa["averaged"]:
            # a step in between: each rank moved on its own data
            assert any(sa["after"][n] != sb["after"][n] for n in names)
            continue
        for n in names:
            want = np.mean([np.asarray(sa["before"][n], "f4"),
                            np.asarray(sb["before"][n], "f4")], axis=0,
                           dtype="f4")
            np.testing.assert_array_equal(np.asarray(sa["after"][n], "f4"),
                                          want, err_msg=n)
            assert sa["after"][n] == sb["after"][n]


def test_two_rank_checkpoint_resumes_at_one_process(cluster):
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.framework import unique_name

    results, out = cluster
    a, b = (r["ckpt"] for r in results)
    assert a["saved"] and set(b["saved"]) < set(a["saved"])
    assert {"shard_r0.npz", "shard_r1.npz", "meta_r0.json",
            "meta_r1.json", "MANIFEST.json"} <= set(a["files"])
    with unique_name.guard():
        main, startup, loss, _ = W.build_model(T, False)
    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(startup, scope=scope)
    restored = dckpt.load_sharded(scope, out + "-ckpt", device="cpu")
    assert restored == a["saved"]
    blocks = [dict(np.load(f"{out}-{r}-blocks.npz")) for r in range(2)]
    for n in blocks[0]:
        np.testing.assert_array_equal(
            scope.get_var(n).numpy(),
            np.concatenate([blocks[0][n], blocks[1][n]]), err_msg=n)
    X, Y = W.make_batch()
    got = float(np.asarray(exe.run(main, feed={"x": X, "y": Y},
                                   fetch_list=[loss],
                                   scope=scope)[0]).ravel()[0])
    assert a["step4_loss"] == b["step4_loss"]
    np.testing.assert_allclose(got, a["step4_loss"], rtol=ORACLE_RTOL,
                               atol=1e-6)


def test_localsgd_with_two_ranks_in_one_process_raises(cluster):
    results, _ = cluster
    for r in results:
        assert r["refusal"] and "per-replica parameter state" in r["refusal"]
