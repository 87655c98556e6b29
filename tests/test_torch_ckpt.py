"""PyTorch port: the checkpoint manager (``paddle_tpu_torch.ckpt``), held
to the JAX package's single-process contracts (``tests/test_ckpt.py``)
and to its on-disk format.

Every comparison here is exact: a checkpoint carries bits, so values
written by either package and read by either come back bit-equal
(float32, int64, bfloat16 and the generator's state).  The port's
reader and writer go through ``torch`` bit views, with ``ml_dtypes``
blocked from import where a test says so.
"""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import ckpt as jckpt
from paddle_tpu.framework.scope import Scope as JScope
import paddle_tpu_torch as tpkg
from paddle_tpu_torch.ckpt import (CheckpointError, CheckpointManager,
                                   GeneratorState, KVBarrier, LocalShard,
                                   ResumableIterator, restore_scope,
                                   snapshot_scope)
from paddle_tpu_torch.framework.scope import Scope
from paddle_tpu_torch.monitor import stat_get, stat_reset


def _state(seed=0, n=4):
    rs = np.random.RandomState(seed)
    return {f"w{i}": rs.randn(8, 4).astype("f4") for i in range(n)}


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x))
        y = y if isinstance(y, torch.Tensor) else torch.from_numpy(
            np.asarray(y))
        assert torch.equal(x.cpu(), y.cpu()), k


def _mixed_scope_values():
    """float32, int64 and bfloat16 values (the bfloat16 as its bits)."""
    rs = np.random.RandomState(5)
    bf = torch.from_numpy(rs.randn(3, 5).astype("f4")).to(torch.bfloat16)
    return {"p": rs.randn(2, 3).astype("f4"),
            "step": np.array([7, -3], "int64"),
            "halfp": bf}


def _no_ml_dtypes(monkeypatch):
    monkeypatch.delitem(sys.modules, "ml_dtypes", raising=False)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)


def test_state_roundtrip_and_layout(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=False)
    st = _state()
    saved = m.save(7, state=st, host_state={"note": "x"})
    assert saved == sorted(st)
    d = tmp_path / "step_7"
    assert d.is_dir() and not (tmp_path / "step_7.tmp").exists()
    assert sorted(os.listdir(d)) == ["MANIFEST.json", "meta_r0.json",
                                     "shard_r0.npz"]
    manifest = json.load(open(d / "MANIFEST.json"))
    assert manifest["format"] == 1 and manifest["world_size"] == 1
    assert set(manifest["files"]) == {"shard_r0.npz", "meta_r0.json"}
    meta_file = json.load(open(d / "meta_r0.json"))
    assert meta_file["format"] == 1 and meta_file["shard"] == "shard_r0.npz"
    assert meta_file["vars"]["w0"] == {"dtype": "float32", "shape": [8, 4],
                                       "sharded": False}
    meta = m.restore(device="cpu")
    assert meta["step"] == 7 and meta["host_state"]["note"] == "x"
    _assert_state_equal(meta["state"], st)
    m.close()


def test_scope_roundtrip_bf16_and_generator_without_ml_dtypes(
        tmp_path, monkeypatch):
    """A scope of float32, int64, bfloat16 and a generator round-trips
    bit-equal with ml_dtypes blocked from import; the restored generator
    draws what the saved one would have."""
    _no_ml_dtypes(monkeypatch)
    sc = Scope()
    for n, v in _mixed_scope_values().items():
        sc.set_var(n, v)
    gen = torch.Generator()
    gen.manual_seed(11)
    torch.rand(3, generator=gen)
    sc.set_var("@RNG_KEY@", gen)
    m = CheckpointManager(str(tmp_path), async_save=True)
    m.save(0, scope=sc, wait=True)
    meta_file = json.load(open(tmp_path / "step_0" / "meta_r0.json"))
    assert meta_file["vars"]["halfp"]["dtype"] == "bfloat16"
    assert meta_file["vars"]["@RNG_KEY@"]["dtype"] == "torch_generator"
    sc2 = Scope()
    meta = m.restore(scope=sc2, device="cpu")
    assert "@RNG_KEY@" in meta["vars"]
    for n in ("p", "step", "halfp"):
        assert sc2.get_var(n).dtype == sc.get_var(n).dtype
        assert torch.equal(sc2.get_var(n), sc.get_var(n)), n
    g2 = sc2.get_var("@RNG_KEY@")
    assert isinstance(g2, torch.Generator) and g2 is not gen
    assert torch.equal(torch.rand(4, generator=g2),
                       torch.rand(4, generator=gen))
    assert sys.modules["ml_dtypes"] is None
    m.close()


def test_checkpoints_cross_between_the_packages(tmp_path):
    """float32, int64 and bfloat16 vars written by the JAX package's
    manager restore bit-equal into the port, and the port's into the JAX
    package; the JAX package's @RNG_KEY@ is refused by name."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    vals = _mixed_scope_values()
    bf_bits = vals["halfp"].view(torch.int16).numpy()
    jsc = JScope()
    jsc.set_var("p", jnp.asarray(vals["p"]))
    jsc.set_var("step", np.asarray(vals["step"]))
    jsc.set_var("halfp", jnp.asarray(bf_bits.view(ml_dtypes.bfloat16)))
    jsc.set_var("@RNG_KEY@", jax.random.PRNGKey(3))
    jm = jckpt.CheckpointManager(str(tmp_path / "jax"), async_save=False)
    jm.save(1, scope=jsc)
    tm = CheckpointManager(str(tmp_path / "jax"))
    sc = Scope()
    names = ["p", "step", "halfp"]
    tm.restore(scope=sc, var_names=names, device="cpu")
    assert torch.equal(sc.get_var("p"), torch.from_numpy(vals["p"]))
    assert sc.get_var("step").dtype == torch.int64
    assert torch.equal(sc.get_var("step"), torch.from_numpy(vals["step"]))
    assert sc.get_var("halfp").dtype == torch.bfloat16
    assert torch.equal(sc.get_var("halfp"), vals["halfp"])
    with pytest.raises(CheckpointError, match="@RNG_KEY@"):
        tm.restore(scope=Scope(), device="cpu")

    tsc = Scope()
    for n, v in vals.items():
        tsc.set_var(n, v)
    CheckpointManager(str(tmp_path / "torch"), async_save=False).save(
        2, scope=tsc)
    jmeta = jckpt.CheckpointManager(str(tmp_path / "torch")).restore()
    got = jmeta["state"]
    np.testing.assert_array_equal(got["p"], vals["p"])
    assert got["step"].dtype == np.int64
    np.testing.assert_array_equal(got["step"], vals["step"])
    assert str(got["halfp"].dtype) == "bfloat16"
    np.testing.assert_array_equal(got["halfp"].view(np.int16), bf_bits)


def test_torn_save_is_invisible_and_falls_back(tmp_path):
    """The writer killed at each fault point: restore() lands on the
    previous intact step, and the torn step stays as a .tmp."""
    for phase in ("serialize", "write_shard", "pre_commit"):
        d = tmp_path / phase
        m = CheckpointManager(str(d), async_save=True)
        m.save(1, state=_state(1), wait=True)

        def hook(p, step, _kill=phase):
            if p == _kill and step == 2:
                raise RuntimeError(f"injected crash at {_kill}")

        m.set_fault_hook(hook)
        m.save(2, state=_state(2))
        with pytest.raises(CheckpointError, match="injected crash"):
            m.wait()
        assert m.all_steps() == [1], phase
        assert (d / "step_2.tmp").is_dir()
        assert m.latest_intact_step() == 1
        meta = m.restore(device="cpu")
        assert meta["step"] == 1, phase
        _assert_state_equal(meta["state"], _state(1))
        assert m.stats[-1]["error"].startswith("RuntimeError")
        m.set_fault_hook(None)
        m.close()


def test_corrupt_committed_shard_detected(tmp_path):
    stat_reset("ckpt_restore_fallbacks")
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(1, state=_state(1))
    m.save(2, state=_state(2))
    p = tmp_path / "step_2" / "shard_r0.npz"
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p.write_bytes(bytes(raw))
    ok, why = m.validate(2)
    assert not ok and "hash mismatch" in why
    assert m.restore(device="cpu")["step"] == 1
    assert stat_get("ckpt_restore_fallbacks") == 1
    (tmp_path / "step_1" / "MANIFEST.json").unlink()
    with pytest.raises(CheckpointError, match="no intact checkpoint"):
        m.restore(device="cpu")
    m.close()


def test_restore_on_missing_dir_and_retention(tmp_path):
    m = CheckpointManager(str(tmp_path / "never_written"))
    assert m.restore(device="cpu") is None
    assert m.latest_intact_step() is None
    m.close()
    m = CheckpointManager(str(tmp_path / "gc"), keep_n=2,
                          keep_every_n_steps=4, async_save=False)
    for s in range(1, 11):
        m.save(s, state={"w": np.full((2,), s, "f4")})
    assert m.all_steps() == [4, 8, 9, 10]
    m.close()
    m = CheckpointManager(str(tmp_path / "all"), keep_n=0, async_save=False)
    for s in range(5):
        m.save(s, state={"w": np.zeros(1, "f4")})
    assert m.all_steps() == [0, 1, 2, 3, 4]
    m.close()


def test_stale_pending_save_coalesced(tmp_path):
    stat_reset("ckpt_saves_coalesced")
    m = CheckpointManager(str(tmp_path), async_save=True)
    step1_started = threading.Event()

    def slow(phase, step):
        if phase == "serialize" and step == 1:
            step1_started.set()
            time.sleep(0.3)

    m.set_fault_hook(slow)
    m.save(1, state={"w": np.full(4, 1.0, "f4")})
    assert step1_started.wait(10)
    m.save(2, state={"w": np.full(4, 2.0, "f4")})
    m.save(3, state={"w": np.full(4, 3.0, "f4")})
    m.wait()
    assert stat_get("ckpt_saves_coalesced") >= 1
    assert 2 not in m.all_steps()
    assert m.restore(device="cpu")["step"] == 3
    assert [s.get("coalesced", False) for s in m.stats] == \
        [False, True, False]
    m.close()


def test_wait_barrier_and_executor_close_drains(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True)

    def slow(phase, step):
        if phase == "serialize":
            time.sleep(0.3)

    m.set_fault_hook(slow)
    m.save(1, state=_state())
    tpkg.Executor(tpkg.CPUPlace()).close()
    assert m.all_steps() == [1]
    assert m.stats[0]["bytes"] == sum(a.nbytes for a in _state().values())
    m.close()


def test_resumable_iterator_position_and_component(tmp_path):
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    xs = np.arange(24, dtype="f4").reshape(24, 1)
    loader = DataLoader(TensorDataset([xs]), batch_size=4, shuffle=False)
    it = ResumableIterator(loader)
    seen = [float(next(it)[0][0, 0]) for _ in range(8)]
    state = it.state_dict()
    assert state == {"epoch": 1, "batch": 2}
    rest = [float(next(it)[0][0, 0]) for _ in range(4)]
    it2 = ResumableIterator(DataLoader(TensorDataset([xs]), batch_size=4,
                                       shuffle=False))
    it2.set_state_dict(state)
    assert [float(next(it2)[0][0, 0]) for _ in range(4)] == rest
    assert seen[:6] == [0, 4, 8, 12, 16, 20]

    batches = [np.full((2,), i, "f4") for i in range(6)]
    it = ResumableIterator(batches)
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.register("data", it)
    next(it), next(it), next(it)
    m.save(3, state={"w": np.zeros(1, "f4")})
    it3 = ResumableIterator(batches)
    m2 = CheckpointManager(str(tmp_path), async_save=False)
    m2.register("data", it3)
    m2.restore(device="cpu")
    np.testing.assert_array_equal(next(it3), batches[3])
    m.close(), m2.close()
    stale = ResumableIterator(batches[:2])
    stale.set_state_dict({"epoch": 0, "batch": 5})
    with pytest.raises(CheckpointError, match="fast-forward"):
        next(stale)


def test_several_processes_raise_the_later_slice_error(tmp_path):
    """Several-process managers and the KVBarrier are ported (their
    cases: ``tests/test_torch_ckpt_ranks.py``): they construct and name
    their topology, and no longer raise the later-slice error; a
    single-process manager still refuses a partial shard."""
    for kw, want in (({"world_size": 2}, (0, 2)), ({"rank": 1}, (1, 1)),
                     ({"barrier": print, "rank": 1, "world_size": 2},
                      (1, 2))):
        m = CheckpointManager(str(tmp_path), **kw)
        assert (m.rank, m.world_size) == want
        m.close()
    b = KVBarrier("127.0.0.1:1", rank=0, world_size=2)
    assert (b.endpoint, b.rank, b.world_size) == (
        "http://127.0.0.1:1", 0, 2)
    m = CheckpointManager(str(tmp_path), async_save=False)
    with pytest.raises(CheckpointError, match="partial shard"):
        m.save(0, state={"s": LocalShard(np.zeros((2, 2), "f4"), (4, 2))})
    m.close()


def test_restore_places_values_on_the_asked_device_and_defaults_to_cuda(
        tmp_path):
    """restore and restore_scope put values on the caller's device: the
    card unless told otherwise, which raises on a host without one."""
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(0, state={"w": np.ones(3, "f4")})
    st = m.restore(device="cpu")["state"]
    assert st["w"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            m.restore()
        with pytest.raises(RuntimeError, match="CUDA"):
            restore_scope(Scope(), {"w": np.ones(1, "f4")})
    g = GeneratorState(torch.Generator().get_state(), "cuda")
    with pytest.raises(CheckpointError, match="cannot seed"):
        g.generator(torch.device("cpu"))
    snap = snapshot_scope(Scope())
    assert snap == {}
    m.close()
