"""PyTorch port: checkpoints written by several ranks, with threads as ranks.

Ports of ``tests/test_ckpt.py``'s several-rank cases, against the port's
``CheckpointManager`` / ``KVBarrier`` over the port's fleet KV server
(``distributed/fleet/utils/http_server.py``): per-rank shard files and a
commit after the barrier, FIFO async saves with a bounded backlog, the
barrier's timeouts, tag generations, sweeps and dead-rank verdicts, the
recovery after an asymmetric failure, and 2-D blocks placed by origin
with a hole refused.  On top: a two-rank checkpoint written by the port
restores in the JAX package to the same values and the reverse; a ZeRO
rank's block of its scope (``Scope.zero_blocks``) snapshots as a
``LocalShard``; the group-store barrier and auto-checkpoint's refusal of
sharded state.  Values are compared exactly.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import ckpt as jckpt
from paddle_tpu.distributed.fleet.utils import KVServer as JKVServer
from paddle_tpu_torch.ckpt import (CheckpointError, CheckpointManager,
                                   KVBarrier, LocalShard, snapshot_scope)
from paddle_tpu_torch.distributed.fleet.utils import KVServer
from paddle_tpu_torch.framework.scope import Scope


@pytest.fixture
def kv():
    srv = KVServer(0)
    srv.start()
    try:
        yield f"127.0.0.1:{srv.port}"
    finally:
        srv.stop()


def _managers(tmp_path, ep, timeout=30, **kw):
    return [CheckpointManager(
        str(tmp_path), rank=r, world_size=2,
        barrier=KVBarrier(ep, rank=r, world_size=2, timeout=timeout),
        **kw) for r in range(2)]


def _on_ranks(fn, n=2, timeout=60):
    """``fn(rank)`` on ``n`` threads; returns each rank's error or None."""
    errs = [None] * n

    def run(r):
        try:
            fn(r)
        except BaseException as e:  # noqa: BLE001
            errs[r] = e

    ts = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "a rank hung"
    return errs


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_two_rank_sharded_commit_over_kv_barrier(tmp_path, kv):
    """Per-rank shard files; rank 0 commits the manifest only after the
    barrier saw both ranks' writes; restore re-assembles the sharded
    value and takes the replicated one from rank 0's file."""
    w = np.arange(12, dtype="f4").reshape(3, 4)
    s_full = np.arange(16, dtype="f4").reshape(8, 2)
    mgrs = _managers(tmp_path, kv, async_save=False)
    states = [{"w": w, "s": LocalShard(s_full[:4], s_full.shape)},
              {"w": w, "s": LocalShard(s_full[4:], s_full.shape)}]
    assert _on_ranks(lambda r: mgrs[r].save(5, state=states[r])) == \
        [None, None]
    manifest = json.load(open(tmp_path / "step_5" / "MANIFEST.json"))
    assert manifest["world_size"] == 2
    assert {"shard_r0.npz", "shard_r1.npz", "meta_r0.json",
            "meta_r1.json"} <= set(manifest["files"])
    # rank 1 wrote only its block
    assert set(np.load(tmp_path / "step_5" / "shard_r1.npz").files) == {"s"}
    meta = mgrs[0].restore(device="cpu")
    np.testing.assert_array_equal(_np(meta["state"]["w"]), w)
    np.testing.assert_array_equal(_np(meta["state"]["s"]), s_full)
    for m in mgrs:
        m.close()


def test_two_rank_async_saves_queue_fifo(tmp_path, kv):
    """Above one rank pending saves are not coalesced: three back-to-back
    async saves from both ranks all commit, in order."""
    mgrs = _managers(tmp_path, kv, keep_n=0, async_save=True)
    full = np.arange(8, dtype="f4")
    for step in (1, 2, 3):
        for r, m in enumerate(mgrs):
            m.save(step, state={"s": LocalShard(
                full[r * 4:(r + 1) * 4] + step, full.shape)})
    assert _on_ranks(lambda r: mgrs[r].wait()) == [None, None]
    assert mgrs[0].all_steps() == [1, 2, 3]
    np.testing.assert_array_equal(
        _np(mgrs[0].restore(device="cpu")["state"]["s"]), full + 3)
    for m in mgrs:
        m.close()


def test_kv_barrier_unreachable_server_times_out_as_checkpoint_error():
    b = KVBarrier("127.0.0.1:9", rank=0, world_size=1, timeout=0.5)
    with pytest.raises(CheckpointError, match="cannot announce"):
        b("commit:1")


def test_kv_barrier_past_tags_trimmed_on_all_ranks(kv):
    bs = [KVBarrier(kv, rank=r, world_size=2, timeout=30) for r in range(2)]

    def run(r):
        for i in range(6):
            bs[r](f"t{i}")

    assert _on_ranks(run) == [None, None]
    for b in bs:
        assert len(b._past_tags) <= 2    # a rank other than 0 trims too
        assert len(b._tag_gens) <= 3     # swept tags drop their gens


def test_save_sharded_explicit_step_and_two_ranks(tmp_path, kv):
    """An explicit step; and save_sharded from two ranks with a
    KVBarrier, each writing its block."""
    from paddle_tpu_torch.distributed import checkpoint as dckpt

    sc = Scope()
    sc.set_var("w", np.ones((2,), "f4"))
    dckpt.save_sharded(sc, str(tmp_path / "one"), step=42)
    m = dckpt._MANAGERS[os.path.abspath(str(tmp_path / "one"))]
    assert m.all_steps() == [42]
    dckpt.save_sharded(sc, str(tmp_path / "one"))  # one past the newest
    assert m.all_steps() == [42, 43]
    full = np.arange(6, dtype="f4").reshape(6, 1)
    states = [{"b": LocalShard(full[r * 3:(r + 1) * 3], full.shape,
                               origin=(r * 3, 0))} for r in range(2)]
    d = str(tmp_path / "two")
    mgrs = [CheckpointManager(d, async_save=False, rank=r, world_size=2,
                              barrier=KVBarrier(kv, r, 2, timeout=30))
            for r in range(2)]
    assert _on_ranks(lambda r: mgrs[r].save(7, state=states[r])) == \
        [None, None]
    got = Scope()
    assert dckpt.load_sharded(got, d, device="cpu") == ["b"]
    np.testing.assert_array_equal(got.get_var("b").numpy(), full)


def test_world1_manager_rejects_partial_shard(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    block = np.arange(4, dtype="f4")
    with pytest.raises(CheckpointError, match="partial shard"):
        m.save(1, state={"s": LocalShard(block, (8,))})
    assert m.all_steps() == []
    # a full LocalShard (block == global) is fine at one process
    m.save(2, state={"s": LocalShard(block, (4,))})
    np.testing.assert_array_equal(
        _np(m.restore(device="cpu")["state"]["s"]), block)
    m.close()


def test_kv_barrier_dead_rank_fails_fast_with_named_rank(kv):
    dead = set()
    b = KVBarrier(kv, rank=0, world_size=2, timeout=30,
                  dead_ranks_fn=lambda: dead)
    threading.Timer(0.4, lambda: dead.add(1)).start()
    t0 = time.monotonic()
    with pytest.raises(CheckpointError, match=r"rank\(s\) \[1\] dead-listed"):
        b("written:9:j0")
    assert time.monotonic() - t0 < 10.0


def test_kv_barrier_dead_rank_fn_errors_do_not_fail_the_barrier(kv):
    def broken():
        raise OSError("aggregator down")

    bs = [KVBarrier(kv, rank=r, world_size=2, timeout=30,
                    dead_ranks_fn=broken) for r in range(2)]
    assert _on_ranks(lambda r: bs[r]("t"), timeout=30) == [None, None]


def test_kv_barrier_stalled_server_times_out_as_checkpoint_error():
    import socket

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    try:
        b = KVBarrier(f"127.0.0.1:{srv.getsockname()[1]}", rank=0,
                      world_size=1, timeout=0.5)
        with pytest.raises(CheckpointError, match="cannot announce"):
            b("x")
    finally:
        srv.close()


def test_multi_rank_async_queue_is_bounded(tmp_path):
    """FIFO has no coalescing, so save() blocks at the backlog cap."""
    release = threading.Event()
    m = CheckpointManager(str(tmp_path), keep_n=0, async_save=True,
                          rank=0, world_size=2, barrier=lambda tag: None)
    m.set_fault_hook(lambda phase, step: release.wait(30)
                     if phase == "serialize" else None)
    for s in (1, 2, 3):  # 1 active (stalled) + 2 queued = the cap
        m.save(s, state={"w": np.zeros(1, "f4")})
    unblocked = threading.Event()

    def extra():
        m.save(4, state={"w": np.zeros(1, "f4")})
        unblocked.set()

    t = threading.Thread(target=extra)
    t.start()
    assert not unblocked.wait(0.5), "the 4th save should block at the cap"
    release.set()
    assert unblocked.wait(20), "save must unblock once the writer drains"
    t.join(timeout=10)
    m.wait()
    assert m.all_steps() == [1, 2, 3, 4]
    m.close()


def test_kv_barrier_resyncs_after_asymmetric_timeout(kv):
    bs = [KVBarrier(kv, rank=r, world_size=2, timeout=30) for r in range(2)]
    bs[1].timeout = 0.5
    with pytest.raises(CheckpointError):
        bs[1]("orphan")  # rank 0 never calls this one
    bs[1].timeout = 30
    assert _on_ranks(lambda r: bs[r]("next"), timeout=30) == [None, None]


def test_multi_rank_save_recovers_after_asymmetric_failure(tmp_path, kv):
    """Rank 0's writer fails mid-save (rank 1 times out at the commit
    barrier); a retry of the same step succeeds."""
    mgrs = _managers(tmp_path, kv, timeout=4, async_save=False)
    boom = {"on": True}

    def fault(phase, step):
        if boom["on"] and phase == "write_shard":
            raise RuntimeError("disk full")

    mgrs[0].set_fault_hook(fault)
    full = np.arange(4, dtype="f4")
    states = [{"s": LocalShard(full[r * 2:(r + 1) * 2], full.shape)}
              for r in range(2)]
    errs = _on_ranks(lambda r: mgrs[r].save(1, state=states[r]))
    assert errs[0] is not None and errs[1] is not None
    assert mgrs[0].all_steps() == []
    boom["on"] = False
    assert _on_ranks(lambda r: mgrs[r].save(1, state=states[r])) == \
        [None, None]
    assert mgrs[0].all_steps() == [1]
    np.testing.assert_array_equal(
        _np(mgrs[0].restore(device="cpu")["state"]["s"]), full)
    for m in mgrs:
        m.close()


def test_two_rank_2d_localshard_commit_and_elastic_restore(tmp_path, kv):
    """Blocks with non-axis-0 / 2-D origins save per rank and restore
    into the full value; a value with a hole fails the restore."""
    col = np.arange(32, dtype="f4").reshape(4, 8)
    row = np.arange(24, dtype="f4").reshape(8, 3)
    grid = np.arange(64, dtype="f4").reshape(8, 8)
    mgrs = _managers(tmp_path, kv, async_save=False)
    states = [
        {"col": LocalShard(col[:, :4], col.shape, origin=(0, 0)),
         "row": LocalShard(row[:4], row.shape, origin=(0, 0)),
         "grid": LocalShard(grid[:, :4], grid.shape, origin=(0, 0)),
         "grid2": LocalShard(grid[4:, :4], grid.shape, origin=(4, 0))},
        {"col": LocalShard(col[:, 4:], col.shape, origin=(0, 4)),
         "row": LocalShard(row[4:], row.shape, origin=(4, 0)),
         "grid": LocalShard(grid[:, 4:], grid.shape, origin=(0, 4)),
         # grid2 leaves (4:, 4:) uncovered
         "grid2": LocalShard(grid[:4, :4], grid.shape, origin=(0, 0))},
    ]
    assert _on_ranks(lambda r: mgrs[r].save(7, state=states[r])) == \
        [None, None]
    with pytest.raises(CheckpointError, match="hole|missing"):
        mgrs[0].restore(device="cpu")
    for st in states:
        st.pop("grid2")
    assert _on_ranks(lambda r: mgrs[r].save(8, state=states[r])) == \
        [None, None]
    meta = mgrs[0].restore(step=8, device="cpu")
    for n, want in (("col", col), ("row", row), ("grid", grid)):
        np.testing.assert_array_equal(_np(meta["state"][n]), want)
    for m in mgrs:
        m.close()


def _two_rank_save(pkg, server_cls, d):
    """A two-rank checkpoint of a replicated and an axis-0-sharded value
    written by ``pkg``'s manager over its KV server."""
    w = np.arange(6, dtype="f4").reshape(2, 3)
    s_full = (np.arange(20, dtype="f4").reshape(10, 2) - 3.5) / 7
    srv = server_cls(0)
    srv.start()
    try:
        ep = f"127.0.0.1:{srv.port}"
        mgrs = [pkg.CheckpointManager(
            d, async_save=False, rank=r, world_size=2,
            barrier=pkg.KVBarrier(ep, rank=r, world_size=2, timeout=30))
            for r in range(2)]
        states = [{"w": w, "s": pkg.LocalShard(
            s_full[r * 5:(r + 1) * 5], s_full.shape,
            origin=(r * 5, 0))} for r in range(2)]
        assert _on_ranks(lambda r: mgrs[r].save(3, state=states[r])) == \
            [None, None]
        for m in mgrs:
            m.close()
    finally:
        srv.stop()
    return {"w": w, "s": s_full}


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_two_rank_checkpoint_crosses_between_the_packages(tmp_path, writer):
    """Written at two ranks by one package, restored at one process by
    the other: the same values, bit for bit."""
    import paddle_tpu_torch.ckpt as tckpt

    d = str(tmp_path / writer)
    if writer == "torch":
        want = _two_rank_save(tckpt, KVServer, d)
        state = jckpt.CheckpointManager(d).restore()["state"]
    else:
        want = _two_rank_save(jckpt, JKVServer, d)
        state = CheckpointManager(d).restore(device="cpu")["state"]
    assert sorted(state) == ["s", "w"]
    for n, v in want.items():
        np.testing.assert_array_equal(_np(state[n]), v, err_msg=n)


def test_a_zero_block_of_the_scope_snapshots_as_a_local_shard():
    """A var the executor cut to this rank's rows (``zero_blocks``) is a
    LocalShard of its block; once a full value replaces it, a plain
    value again."""
    sc = Scope()
    sc.set_var("m", np.arange(6, dtype="f4").reshape(3, 2))
    sc.set_var("p", np.ones((6, 2), "f4"))
    sc.zero_blocks["m"] = ((6, 2), (3, 0))
    snap = snapshot_scope(sc)
    assert isinstance(snap["m"], LocalShard)
    assert snap["m"].global_shape == (6, 2) and snap["m"].origin == (3, 0)
    np.testing.assert_array_equal(snap["m"].array.numpy(),
                                  np.arange(6, dtype="f4").reshape(3, 2))
    assert isinstance(snap["p"], torch.Tensor)
    sc.set_var("m", np.zeros((6, 2), "f4"))   # a restored full value
    assert isinstance(snapshot_scope(sc)["m"], torch.Tensor)


def test_store_barrier_and_auto_checkpoint_refuse_sharded_state(
        tmp_path, monkeypatch):
    """Without a group above one rank the default barrier returns at
    once; a rank-0 auto-checkpoint of ZeRO-sharded state raises, naming
    save_sharded."""
    from paddle_tpu_torch.ckpt import manager
    from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as acp

    manager._default_barrier("mkdir:0:j0")   # one rank: nothing to wait
    sc = Scope()
    sc.set_var("m", np.zeros((2, 2), "f4"))
    sc.zero_blocks["m"] = ((4, 2), (0, 0))
    cfg = acp.configure(str(tmp_path), every_n_steps=1, async_save=False)
    try:
        with pytest.raises(CheckpointError, match="save_sharded"):
            acp.save_checkpoint(None, None, sc, cfg)
    finally:
        acp.disable()
