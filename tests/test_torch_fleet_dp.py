"""PyTorch port: the data-parallel rewrites and rules, in one process.

- ``GradAllReduce(nranks=2)`` (``distributed/fleet/collective_transpiler``)
  on a 2-layer, hidden-64 BERT pretrain built by both packages equals the
  JAX package's transpile op for op (types, slots, attrs), with ``fp16``
  on and off and with the fusion marks on and off; under bf16 AMP the
  port's AMP program goes through both transpiles, and the 1/nranks
  scale sits right after the ``fill_constant`` seeding the loss
  gradient, before any AMP op reads it.
- ``FuseAllReducePass`` of the port equals the JAX pass's rewrite op for
  op, and sets the same stats, at two bucket sizes; on a layer-scanned
  program the whole pipeline (scan pull-out, then the buckets closed at
  their read barriers) equals the JAX pipeline's.
- ``executor.dp_varying`` gives the set the JAX executor's dp-variance
  analysis gives (read from its ``_build_sharded_fn``), on the transpiled
  program before and after the fusion.
- ``capture_reason``: ``host_collective`` under gloo (and for a
  ``barrier`` under NCCL), None under NCCL and without a group.
- A one-rank gloo group (``PADDLE_DISTRI_BACKEND=gloo``) runs a fleet
  program's collectives as identities, eagerly and counted; the backend
  and rendezvous errors name their variables.

Two real ranks: ``tests/test_torch_multiprocess.py``.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
import torch_dist_trainer as W
import torch_layer_scan_models as M
from paddle_tpu.distributed.fleet import collective_transpiler as jct
from paddle_tpu.framework import passes as jpasses
from paddle_tpu.monitor import stat_get as jstat
from paddle_tpu_torch.distributed import parallel_env as tenv
from paddle_tpu_torch.distributed.fleet import collective_transpiler as tct
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.monitor import stat_get, stat_reset

PKG = {"jax": (J, jct, jpasses), "torch": (T, tct, tpasses)}
FUSE_STATS = ("pass_fused_allreduce_buckets", "pass_allreduce_ops_before",
              "pass_allreduce_ops_after")


def _bert(which, amp=False):
    p = PKG[which][0]
    from importlib import import_module

    unique = import_module(p.__name__ + ".framework.unique_name")
    prog = import_module(p.__name__ + ".framework.program")
    build = import_module(p.__name__ + ".text").bert_base_pretrain_program
    decorate = import_module(p.__name__ + ".amp").decorate
    with unique.guard():
        main, startup, _f, loss, opt = build(batch_size=2, **W.BERT_CFG)
        main.random_seed = 1
        with prog.program_guard(main, startup):
            _, params_grads = (decorate(opt, use_bf16=True) if amp
                               else opt).minimize(loss)
    return main, loss, params_grads


def _transpiled(which, amp=False, fp16=False, fuse=True, mb=32):
    """The BERT transpiled by ``which`` package's ``GradAllReduce``.  The
    two packages' bf16 AMP rewrites differ (the port casts in the
    program), so an AMP case transpiles the port's AMP program in both,
    each parsed from its ``__model__`` bytes."""
    main, loss, pg = _bert("torch" if amp else which, amp)
    if amp:
        main = PKG[which][0].framework.Program.parse_from_string(
            main.serialize_to_string())
        pg = [(p.name, g.name) for p, g in pg]
    PKG[which][1].GradAllReduce(2, fuse_all_reduce=fuse, fp16=fp16,
                                fuse_grad_size_in_MB=mb).transpile(
        main, pg, loss_grad_name=loss.name + "@GRAD")
    return main, loss


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("fp16", [False, True])
@pytest.mark.parametrize("amp", [False, True])
def test_grad_allreduce_equals_the_jax_transpile(amp, fp16, fuse):
    jmain, jloss = _transpiled("jax", amp, fp16, fuse)
    tmain, _ = _transpiled("torch", amp, fp16, fuse)
    ours, theirs = M.op_list(tmain), M.op_list(jmain)
    assert ours == theirs
    types = [op[0] for op in ours]
    # one loss-gradient scale, right after the fill_constant seeding it
    grad = jloss.name + "@GRAD"
    scales = [i for i, op in enumerate(ours) if op[0] == "scale"
              and op[3].get(tpasses.DP_LOSS_SCALE_ATTR)]
    assert len(scales) == 1 and ours[scales[0] - 1][0] == "fill_constant" \
        and ours[scales[0] - 1][2]["Out"] == [grad]
    n_params = sum(1 for v in tmain.global_block.vars.values()
                   if getattr(v, "is_parameter", False))
    assert types.count("c_allreduce_sum") == n_params
    marked = [op for op in ours if op[3].get(tpasses.FUSED_ALLREDUCE_ATTR)]
    assert bool(marked) == fuse


def _fused(which, program):
    p = PKG[which][2]
    for k in FUSE_STATS:
        stat_reset(k)
        J.monitor.stat_reset(k)
    out = program.clone()
    changed = p.FuseAllReducePass().apply(out, p.PassContext())
    return out, changed


@pytest.mark.parametrize("mb", [0.004, 32])
@pytest.mark.parametrize("fp16", [False, True])
def test_fuse_allreduce_equals_the_jax_pass(mb, fp16):
    jmain, _ = _transpiled("jax", fp16=fp16, mb=mb)
    tmain, _ = _transpiled("torch", fp16=fp16, mb=mb)
    jout, jchanged = _fused("jax", jmain)
    jstats = [jstat(k) for k in FUSE_STATS]
    tout, tchanged = _fused("torch", tmain)
    assert tchanged and jchanged
    assert M.op_list(tout) == M.op_list(jout)
    assert [stat_get(k) for k in FUSE_STATS] == jstats
    buckets = stat_get("pass_fused_allreduce_buckets")
    assert buckets == sum(op.type == "c_allreduce_sum"
                          and bool(op.attr(tpasses.COMM_ID_ATTR))
                          for op in tout.global_block.ops)
    # a small cap makes several buckets, the default one
    assert (buckets > 1) == (mb < 1)
    fused = {op.outputs["FusedOutput"][0]: op for op in
             tout.global_block.ops if op.type == "coalesce_tensor"}
    for name in fused:
        want = jout.global_block.var(name)
        got = tout.global_block.var(name)
        assert list(got.shape) == list(want.shape)


def test_fuse_allreduce_composes_with_layer_scan():
    """The 4-layer BERT, transpiled, through both full pipelines with the
    scan on: the pulled-out carrier allreduces and the edge layers' fuse
    into the same buckets, closed at the same read barriers, with the
    overlap stretch (FLAGS_overlap_grad_allreduce) on and off."""
    stretched = {}
    for overlap in (True, False):
        progs = {}
        stat_reset("pass_overlap_stretched_buckets")
        J.monitor.stat_reset("pass_overlap_stretched_buckets")
        for which in ("jax", "torch"):
            p, ct, passes = PKG[which]
            main, _startup, loss = M.bert(p)
            grads = [(v.name, v.name + "@GRAD")
                     for v in main.global_block.vars.values()
                     if getattr(v, "is_parameter", False)]
            ct.GradAllReduce(2, fuse_grad_size_in_MB=0.004).transpile(
                main, grads, loss_grad_name=loss.name + "@GRAD")
            M.set_scan(p, True, min_layers=2)
            p.set_flags({"FLAGS_overlap_grad_allreduce": overlap})
            try:
                progs[which] = passes.apply_passes(
                    main, fetch_names=(loss.name,),
                    feed_names=tuple(M.bert_feed()))
            finally:
                M.set_scan(p, False)
                p.set_flags({"FLAGS_overlap_grad_allreduce": True})
        stretched[overlap] = stat_get("pass_overlap_stretched_buckets")
        assert stretched[overlap] == \
            jstat("pass_overlap_stretched_buckets")
        jout, tout = progs["jax"], progs["torch"]
        assert M.op_list(tout) == M.op_list(jout)
        types = [op.type for op in tout.global_block.ops]
        assert "layer_scan" in types and "coalesce_tensor" in types
        for op in tout.global_block.ops:
            if op.type == "layer_scan":
                blk = int(op.attr("layer_block"))
                assert M.op_list(tout, blk) == M.op_list(jout, blk)
    # the stretch closed a bucket at the scan boundary only when on
    assert stretched[True] >= 1 and stretched[False] == 0


def _jax_varying(program, feeds):
    """The JAX executor's dp-variance set: built by ``_build_sharded_fn``
    over a one-device 'dp' mesh and read from its step's closure (the
    largest set of names there)."""
    import jax

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    spec = [(n, tuple(v.shape), str(v.dtype)) for n, v in feeds.items()]
    fn, _ = J.Executor(J.CPUPlace())._build_sharded_fn(
        program, mesh, spec, list(feeds), [], [], [], [], lambda *a, **k: 0)
    found, seen = [], set()

    def walk(f, depth):
        if id(f) in seen or depth > 8:
            return
        seen.add(id(f))
        for c in getattr(f, "__closure__", None) or ():
            try:
                v = c.cell_contents
            except ValueError:
                continue
            if isinstance(v, set) and v and all(isinstance(n, str)
                                                for n in v):
                found.append(v)
            elif callable(v):
                walk(v, depth + 1)
        if getattr(f, "__wrapped__", None) is not None:
            walk(f.__wrapped__, depth + 1)

    walk(fn, 0)
    return max(found, key=len)


@pytest.mark.parametrize("fused", [False, True])
def test_dp_variance_matches_the_jax_analysis(fused):
    feeds = W.bert_shard(W.bert_feeds(1)[0], 0, 2)
    jmain, _ = _transpiled("jax")
    tmain, _ = _transpiled("torch")
    if fused:
        jmain, _ = _fused("jax", jmain)
        tmain, _ = _fused("torch", tmain)
    want = _jax_varying(jmain, feeds)
    got = texecutor.dp_varying(tmain, feeds)
    assert set(got) == want
    # the loss varies; an allreduced gradient and a parameter do not
    grads = [op.inputs["X"][0] for op in tmain.global_block.ops
             if op.type == "c_allreduce_sum"]
    assert grads and not any(g in got for g in grads if "@FUSED" not in g)
    assert "input_ids" in got and "nsp_labels" in got


def _collective_program():
    main = T.framework.Program()
    block = main.global_block
    block.create_var(name="x", shape=[4, 6], dtype="float32")
    block.create_var(name="y", shape=[4, 6], dtype="float32")
    block.append_op("c_allreduce_sum", {"X": ["x"]}, {"Out": ["y"]},
                    {"ring_id": 0})
    return main


@pytest.mark.parametrize("backend,want", [
    (None, None), ("nccl", None), ("gloo", "host_collective")])
def test_capture_reason_by_backend(backend, want, monkeypatch):
    monkeypatch.setattr(tenv, "backend", lambda: backend)
    reason = texecutor.capture_reason(_collective_program())
    assert (reason and reason[0]) == want
    if backend == "nccl":
        main = _collective_program()
        main.global_block.append_op("barrier", {"X": ["y"]},
                                    {"Out": ["y"]}, {"ring_id": 0})
        assert texecutor.capture_reason(main)[0] == "host_collective"


@pytest.mark.parametrize("env,match", [
    ({"PADDLE_DISTRI_BACKEND": "mpi"}, "PADDLE_DISTRI_BACKEND='mpi'"),
    ({"PADDLE_DISTRI_BACKEND": "gloo"}, "PADDLE_COORDINATOR")])
def test_backend_and_rendezvous_errors_name_their_variable(env, match,
                                                           monkeypatch):
    for k in ("PADDLE_COORDINATOR", "PADDLE_TRAINER_ENDPOINTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        tenv.init_parallel_env()
    assert not tenv.group_live()


def test_one_rank_gloo_group_runs_a_fleet_program(monkeypatch):
    """World size 1 over a real gloo group: the collectives are the
    identity through torch.distributed, each counted, and every run of
    the program is eager for the stated reason."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "gloo")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    tenv.init_parallel_env()
    try:
        assert tenv.group_live() and tenv.backend() == "gloo"
        assert (tenv.get_world_size(), tenv.get_rank()) == (1, 0)
        main = _collective_program()
        stat_reset("comm_calls")
        stat_reset("executor_eager_host_collective")
        x = np.random.RandomState(0).randn(4, 6).astype("f4")
        exe = T.Executor(T.CPUPlace())
        for _ in range(2):
            y = exe.run(main, feed={"x": x}, fetch_list=["y"],
                        scope=T.framework.Scope())[0]
            np.testing.assert_array_equal(y, x)
        assert stat_get("comm_calls") == 2
        assert stat_get("executor_eager_host_collective") == 2
        T.distributed.barrier()
    finally:
        tenv.destroy_parallel_env()
    assert not tenv.group_live()
