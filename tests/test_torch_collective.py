"""PyTorch port: the ``c_*`` collective ops at one rank, in a static
program and through the eager collective functions, ``dgc`` and
``uncoalesce_tensor``, ``DataParallel`` at world size 1, and
``paddle.distributed``'s API.spec names, each against the JAX package
(world size 1: a one-device mesh, where every collective is the
identity).  Collectives move values unchanged, so they are compared bit
for bit; ``dgc`` within 1e-6 (float32 sums).  The JAX package's eager
key stream is restored after the module (``_jax_eager_keys_kept``):
``DataParallel``'s layers are built after ``seed``."""
import importlib
import os
import re

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_dygraph_parity import _jax_eager_keys_kept  # noqa: F401
from torch_fleet_parity import build_both, run_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDENTITIES = ["c_allreduce_sum", "allreduce", "mp_allreduce_sum",
              "c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
              "c_broadcast", "c_allgather", "c_reducescatter",
              "c_reduce_sum", "c_reduce_max", "c_reduce_min", "c_scatter",
              "c_concat", "c_split", "c_identity", "c_shard_slice",
              "barrier", "c_sync_calc_stream", "c_sync_comm_stream",
              "c_wait_comm", "c_wait_compute"]
X = np.random.RandomState(3).randn(4, 6).astype("f4")


def _one_op_program(p, op_types, inputs=None, attrs=None):
    main, startup = p.framework.Program(), p.framework.Program()
    outs = []
    with p.framework.program_guard(main, startup):
        x = p.layers.data("x", [4, 6], append_batch_size=False)
        block = main.global_block
        for t in op_types:
            out = block.create_var(name=t + "_out", shape=[4, 6],
                                   dtype="float32")
            block.append_op(t, inputs or {"X": [x.name]},
                            {"Out": [out.name]}, dict(attrs or {},
                                                      ring_id=0))
            outs.append(out)
    return main, startup, outs


def test_c_ops_are_identities_in_a_static_program():
    (jm, js, jf), (tm, ts, tf) = build_both(
        lambda p: _one_op_program(p, IDENTITIES))
    want, got, _, _ = run_both((jm, js), (tm, ts), [{"x": X}], tf)
    for t, w, g in zip(IDENTITIES, want[0], got[0]):
        np.testing.assert_array_equal(g, X, err_msg=t)
        np.testing.assert_array_equal(g, w, err_msg=t)


def test_comm_bootstrap_ops_run_as_no_ops():
    main, startup = T.framework.Program(), T.framework.Program()
    with T.framework.program_guard(main, startup):
        x = T.layers.data("x", [4, 6], append_batch_size=False)
        y = T.layers.scale(x, 2.0)
        for t in ("c_gen_nccl_id", "c_comm_init", "c_comm_init_all"):
            main.global_block.append_op(t, {}, {}, {"ring_id": 0})
    out = T.Executor(T.CPUPlace()).run(main, feed={"x": X}, fetch_list=[y])
    np.testing.assert_array_equal(out[0], 2 * X)


@pytest.mark.parametrize("op_type", ["send_v2", "recv_v2", "partial_send",
                                     "partial_recv"])
def test_point_to_point_ops_wait_for_several_ranks(op_type):
    main, startup, outs = _one_op_program(T, [op_type],
                                          attrs={"peer": 1})
    with pytest.raises(NotImplementedError, match="item 8"):
        T.Executor(T.CPUPlace()).run(main, feed={"x": X}, fetch_list=[])


def _dgc_program(p, begin):
    main, startup = p.framework.Program(), p.framework.Program()
    with p.framework.program_guard(main, startup):
        names = {}
        for n in ("g", "u", "v", "step"):
            names[n] = p.layers.data(n, [1] if n == "step" else [4, 6],
                                     append_batch_size=False).name
        block = main.global_block
        outs = {s: block.create_var(name="dgc_" + s, shape=[4, 6],
                                    dtype="float32")
                for s in ("U_out", "V_out", "EncodeGrad")}
        block.append_op("dgc", {"Grad": [names["g"]], "U": [names["u"]],
                                "V": [names["v"]],
                                "CurrentStep": [names["step"]]},
                        {s: [v.name] for s, v in outs.items()},
                        {"m": 0.9, "ratio": 0.25,
                         "rampup_begin_step": float(begin)})
    return main, startup, list(outs.values())


@pytest.mark.parametrize("begin", [0, 5], ids=["engaged", "before_rampup"])
def test_dgc_matches_jax(begin):
    rs = np.random.RandomState(4)
    feed = {n: rs.randn(4, 6).astype("f4") for n in ("g", "u", "v")}
    feed["step"] = np.array([2.0], "f4")
    (jm, js, jf), (tm, ts, tf) = build_both(lambda p: _dgc_program(p, begin))
    want, got, _, _ = run_both((jm, js), (tm, ts), [feed], tf)
    for w, g in zip(want[0], got[0]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    enc = got[0][2]
    if begin:   # the dense gradient passes through
        np.testing.assert_array_equal(enc, feed["g"])
    else:       # a quarter of the 24 elements kept
        assert np.count_nonzero(enc) == 6


def test_uncoalesce_tensor_matches_jax():
    def build(p):
        main, startup = p.framework.Program(), p.framework.Program()
        with p.framework.program_guard(main, startup):
            f = p.layers.data("fused", [10], append_batch_size=False)
            block = main.global_block
            outs = [block.create_var(name=f"m{i}", dtype="float32",
                                     shape=s)
                    for i, s in enumerate(([2, 3], [4]))]
            block.append_op("uncoalesce_tensor", {"Input": [f.name]},
                            {"Output": [o.name for o in outs]},
                            {"sections": [6, 4], "dims": [2, 3, 4],
                             "ranks": [2, 1]})
        return main, startup, outs

    fused = np.arange(10, dtype="f4")
    (jm, js, jf), (tm, ts, tf) = build_both(build)
    want, got, _, _ = run_both((jm, js), (tm, ts), [{"fused": fused}], tf)
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][0], fused[:6].reshape(2, 3))


def _eager(p):
    d = p.distributed
    t = p.to_tensor(X.copy())
    outs = [d.all_reduce(t), d.all_reduce(t, op=d.ReduceOp.MAX),
            d.broadcast(t, src=0), d.reduce(t, dst=0)]
    gathered = []
    outs.append(d.all_gather(gathered, t))
    outs.extend(gathered)
    outs.append(d.scatter(t, [p.to_tensor(X[:2].copy()),
                              p.to_tensor(X[2:].copy())]))
    d.barrier()
    return [np.asarray(o.numpy()) for o in outs] + [t.numpy()], \
        (d.get_rank(), d.get_world_size())


def test_eager_collectives_write_back_and_match_jax(monkeypatch):
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    T.set_device("cpu")
    jvals, jinfo = _eager(J)
    tvals, tinfo = _eager(T)
    assert tinfo == jinfo == (0, 1)
    assert len(tvals) == len(jvals)
    for w, g in zip(jvals, tvals):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, X)


def test_static_collective_functions_append_their_ops():
    main, startup = T.framework.Program(), T.framework.Program()
    with T.framework.program_guard(main, startup):
        x = T.layers.data("x", [4, 6], append_batch_size=False)
        T.distributed.all_reduce(x)
        T.distributed.broadcast(x, src=0)
    assert [op.type for op in main.global_block.ops] == \
        ["c_allreduce_sum", "c_broadcast"]


def _linear(p):
    p.seed(5)
    return p.nn.Sequential(p.nn.Linear(6, 3), p.nn.Tanh())


def test_data_parallel_at_world_size_one():
    T.set_device("cpu")
    inner = _linear(T)
    dp = T.distributed.DataParallel(inner)
    jdp = J.distributed.DataParallel(_linear(J))
    assert list(dp.state_dict()) == list(jdp.state_dict())
    assert list(dp.state_dict()) == list(inner.state_dict())
    x = T.to_tensor(X)
    y = dp(x)
    np.testing.assert_array_equal(y.numpy(), inner(x).numpy())
    loss = T.mean(y)
    assert dp.scale_loss(loss) is loss
    loss.backward()
    grads = [p.grad.numpy().copy() for p in dp.parameters()]
    assert dp.apply_collective_grads() is None
    for p, g in zip(dp.parameters(), grads):
        np.testing.assert_array_equal(p.grad.numpy(), g)
    assert [n for n, _ in dp.named_parameters()] == \
        [n for n, _ in inner.named_parameters()]
    state = {k: v.numpy() * 0 for k, v in inner.state_dict().items()}
    dp.set_state_dict(state)
    assert all(not v.numpy().any() for v in inner.state_dict().values())
    env = T.distributed.prepare_context()
    assert (env.rank, env.world_size) == (0, 1)
    assert T.distributed.spawn(lambda a: a + 1, args=(2,)) == 3
    # two rank processes over gloo (no card here): rank 0's result
    import torch_elastic_trainer as E

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLOO_SOCKET_IFNAME", "lo")
        mp.setenv("CUDA_VISIBLE_DEVICES", "")
        mp.delenv("PADDLE_DISTRI_BACKEND", raising=False)
        got = T.distributed.spawn(E.spawn_probe, args=(1.0,), nprocs=2)
    assert got == {"rank": 0, "world": 2, "backend": "gloo",
                   "sum": [3.0] * 4}


# API.spec names of paddle.distributed that stay unresolved in the port,
# each with the ROADMAP Queue A item it waits for
UNRESOLVED = {
    "embedding": "item 8 (the sharded embedding)",
    "fleet.distributed_embedding": "item 8 (the sharded embedding)",
}


def _resolve(name):
    parts = name.replace("paddle_tpu.", "paddle_tpu_torch.", 1).split(".")
    obj = importlib.import_module(parts[0])
    for i, part in enumerate(parts[1:], 1):
        try:
            obj = getattr(obj, part)
        except AttributeError:
            obj = importlib.import_module(".".join(parts[:i + 1]))
    return obj


def test_api_spec_distributed_names_resolve_to_the_ports_own():
    names = [re.split(r"[ (]", line.strip(), 1)[0]
             for line in open(os.path.join(ROOT, "API.spec"))
             if line.startswith("paddle_tpu.distributed")]
    missing = []
    for n in names:
        try:
            obj = _resolve(n)
        except Exception:   # noqa: BLE001 - any failure leaves it unresolved
            missing.append(n)
            continue
        where = getattr(obj, "__module__", None) or getattr(
            obj, "__name__", "")
        if where:
            assert where.startswith("paddle_tpu_torch"), (n, where)
    short = [n[len("paddle_tpu.distributed."):] for n in missing]
    waits = {}
    for s in short:
        key = next(k for k in UNRESOLVED
                   if s == k or s.startswith(k + "."))
        waits.setdefault(key, []).append(s)
    assert len(names) == 79
    assert {k: len(v) for k, v in waits.items()} == {
        "embedding": 6, "fleet.distributed_embedding": 1}
