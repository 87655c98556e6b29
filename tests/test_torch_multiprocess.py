"""PyTorch port: two real processes over gloo on the CPU.

The port's counterpart of ``tests/test_multiprocess.py``: the port's
launcher (``paddle_tpu_torch.distributed.launch``) starts two trainers of
``tests/torch_dist_trainer.py`` with the fleet env contract and
``PADDLE_DISTRI_BACKEND=gloo``; one run of them does every check below
(the cluster is started once for the module), and the one-process runs
they are held to run here.

- The JAX oracle's network (``tests/dist_trainer.build_model``) through
  ``fleet`` at two ranks, 5 steps: both ranks fetch the same losses, bit
  for bit, within 1e-5 of the JAX package's one-process run (the
  reference test's ``rtol``; float32 sums in another order); the batched
  ``pred`` fetch is the global batch.
- A 2-layer, hidden-64 BERT pretrain, 3 steps from the JAX startup's
  values: within 1e-4 of the one-process port and of the one-process
  JAX package (float32, as ``tests/test_torch_bert.py``); with
  ``fuse_all_reduce_ops`` on and off the losses and every parameter are
  bit-equal (a sum of two values is the same in any bucket).
- Dygraph ``DataParallel``: the analytic full-batch trajectory of
  ``test_two_process_dygraph_data_parallel_parity``, within 1e-4.
- Each ``c_*`` lowering at two ranks against what the JAX rule's
  semantics give (numpy), exactly.
- The role maker's all-gather, ``fleet.barrier_worker`` and
  ``distributed.barrier``; per-rank dropout masks differ while the
  startup's parameters are equal on both ranks.
"""
import json
import os
import socket

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
import torch_dist_trainer as W
from paddle_tpu_torch.distributed.launch import (start_local_trainers,
                                                 terminate_local_procs,
                                                 watch_local_trainers)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ORACLE_RTOL = 1e-5
BERT_TOL = 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bert_init(path):
    """The JAX startup's values of the small BERT, saved for the ranks."""
    main, startup, _ = W.bert_program(J)
    scope = J.framework.Scope()
    J.Executor(J.CPUPlace()).run(startup, scope=scope)
    init = {v.name: np.asarray(scope.get_var(v.name))
            for v in startup.global_block.vars.values()
            if v.persistable and scope.has_var(v.name)}
    np.savez(path, **init)
    return init


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cluster")
    init = _bert_init(str(tmp / "init.npz"))
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
                os.path.join(HERE, "torch_dist_trainer.py"),
                [out, str(tmp / "init.npz")], log_dir=str(tmp / "logs"))
            rc = watch_local_trainers(procs)
        finally:
            terminate_local_procs(procs)
    if rc != 0:
        logs = "".join(f"\n----- {f} -----\n" + open(
            os.path.join(tmp, "logs", f)).read()[-3000:]
            for f in sorted(os.listdir(tmp / "logs")))
        raise AssertionError(f"cluster exited rc={rc}{logs}")
    return [json.load(open(f"{out}-{r}.json")) for r in range(2)], init


def _jax_oracle(steps=5):
    import dist_trainer

    main, startup, loss = dist_trainer.build_model(use_fleet=False)
    X, Y = dist_trainer.make_batch()
    exe = J.Executor(J.CPUPlace())
    scope = J.framework.Scope()
    exe.run(startup, scope=scope)
    losses, first_pred = [], None
    for _ in range(steps):
        lv, pv = exe.run(main, feed={"x": X, "y": Y},
                         fetch_list=[loss, _last_fc_out(main)], scope=scope)
        losses.append(float(np.asarray(lv).ravel()[0]))
        if first_pred is None:
            first_pred = np.asarray(pv)
    return losses, first_pred


def _last_fc_out(main):
    """The oracle network's prediction: the second fc's output."""
    fcs = [op for op in main.global_block.ops if op.type in ("mul",
                                                               "matmul_v2")]
    return fcs[1].outputs["Out"][0]


def test_ranks_join_one_gloo_group(cluster):
    results, _ = cluster
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["nranks"] == 2 and r["backend"] == "gloo" for r in results)
    # every fleet step ran eagerly, for the stated reason
    assert all(r["eager_host_collective"] > 0 for r in results)
    assert all(r["comm_calls"] > 0 for r in results)


def test_oracle_model_matches_the_jax_package_at_one_process(cluster):
    results, _ = cluster
    want, want_pred = _jax_oracle()
    a, b = (r["oracle"] for r in results)
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"], want, rtol=ORACLE_RTOL,
                               atol=1e-6)
    assert a["scale_ops"] == 1 and a["allreduce_ops"] >= 1
    # the batched fetch is the global batch, in rank order
    pred = np.asarray(a["pred"])
    assert pred.shape == want_pred.shape == (32, 1)
    np.testing.assert_allclose(pred, want_pred, rtol=ORACLE_RTOL, atol=1e-6)
    assert a["pred"] == b["pred"]


def test_small_bert_matches_both_packages_at_one_process(cluster):
    results, init = cluster
    feeds = [W.bert_shard(f, 0, W.B) for f in W.bert_feeds()]
    # the JAX package at one process
    jmain, _, jloss = W.bert_program(J)
    jscope = J.framework.Scope()
    for n, v in init.items():
        jscope.set_var(n, v)
    jexe = J.Executor(J.CPUPlace())
    want = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0]).ravel()[0])
            for f in feeds]
    # the port at one process
    from paddle_tpu_torch.framework.scope import scope_from_numpy

    tmain, _, tloss = W.bert_program(T)
    tscope = scope_from_numpy(init, "cpu")
    texe = T.Executor(T.CPUPlace())
    ours = [float(np.asarray(texe.run(tmain, feed=f, fetch_list=[tloss],
                                      scope=tscope)[0]).ravel()[0])
            for f in feeds]
    np.testing.assert_allclose(ours, want, rtol=BERT_TOL, atol=BERT_TOL)
    for r in results:
        got = r["bert"]["fuse"]["losses"]
        np.testing.assert_allclose(got, ours, rtol=BERT_TOL, atol=BERT_TOL)
        np.testing.assert_allclose(got, want, rtol=BERT_TOL, atol=BERT_TOL)
    assert results[0]["bert"] == results[1]["bert"]


def test_fused_and_unfused_allreduce_are_bit_equal(cluster):
    results, _ = cluster
    for r in results:
        fuse, nofuse = r["bert"]["fuse"], r["bert"]["nofuse"]
        assert fuse["buckets"] >= 1
        assert fuse["losses"] == nofuse["losses"]
        assert fuse["digest"] == nofuse["digest"]


def test_dygraph_data_parallel_reproduces_the_full_batch(cluster):
    results, _ = cluster
    X, Y = W.make_batch()
    w = np.full((8, 1), 0.1, "f4")
    base = []
    for _ in range(5):
        diff = X @ w - Y
        base.append(float(np.mean(diff * diff)))
        w = w - 0.05 * (2.0 * X.T @ diff / len(X))
    for r in results:
        np.testing.assert_allclose(r["dygraph"]["losses"], base,
                                   rtol=1e-4, atol=1e-6)
    assert results[0]["dygraph"] == results[1]["dygraph"]


def _rule_want(t, rank):
    x = [W.rule_input(r) for r in range(2)]
    if t == "c_allreduce_max":
        return np.maximum(*x)
    if t == "c_allreduce_min":
        return np.minimum(*x)
    if t == "c_allreduce_prod":
        return x[0] * x[1]
    if t == "c_broadcast":          # root 1
        return x[1]
    if t == "c_allgather":
        return np.concatenate(x, 0)
    if t == "c_reducescatter":
        return (x[0] + x[1])[rank * 2:(rank + 1) * 2]
    if t == "c_reduce_sum":         # root 1; the others keep their input
        return x[0] + x[1] if rank == 1 else x[rank]
    if t == "c_reduce_max":         # root 0
        return np.maximum(*x) if rank == 0 else x[rank]
    if t == "c_scatter":            # root 0's rows, this rank's tile
        return x[0][rank * 2:(rank + 1) * 2]
    if t == "c_concat":
        return np.concatenate(x, -1)
    if t == "c_split":
        return x[rank][:, rank * 3:(rank + 1) * 3]
    raise KeyError(t)


def test_collective_rules_at_two_ranks(cluster):
    results, _ = cluster
    for rank, r in enumerate(results):
        assert r["rules"]["input_unchanged"]
        for t, _ in W.RULE_OPS:
            np.testing.assert_array_equal(
                np.asarray(r["rules"][t], "f4"), _rule_want(t, rank),
                err_msg=f"{t} on rank {rank}")


def test_role_maker_and_barriers_cross_the_ranks(cluster):
    results, _ = cluster
    for rank, r in enumerate(results):
        assert r["role"] == {"gathered": [{"rank": 0}, {"rank": 1}],
                             "worker_num": 2, "worker_index": rank}


def test_dropout_masks_differ_and_startup_is_equal(cluster):
    results, _ = cluster
    a, b = (r["dropout"] for r in results)
    assert a["param_sums"] == b["param_sums"] and a["param_sums"]
    # the gathered mask: rank 0's rows, then rank 1's, which differ
    assert a["mask_shape"] == [128, 64] and not a["mask_halves_equal"]
    assert a == b
    assert abs(a["keep_share"] - 0.5) < 0.05
