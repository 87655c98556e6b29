"""PyTorch port: the executor's flags, the NaN/Inf scan and fetch-list
pruning, held to the JAX package (``tests/test_flags_prune.py``).

Tolerances: a pruned run's loss against the JAX package's from the same
startup values within 1e-6 relative (float32, one forward); the port's
pruned and unpruned losses of one state within 1e-6 relative (the
reference's bound); state a pruned run must leave alone, bit-equal.
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jpkg
from paddle_tpu import layers as jlayers
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.program import Program as JProgram
from paddle_tpu.framework.program import program_guard as jguard
from paddle_tpu.optimizer import MomentumOptimizer as JMomentum
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.ckpt import (CheckpointError, restore_scope,
                                   snapshot_scope)
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.program import Program as TProgram
from paddle_tpu_torch.framework.program import program_guard as tguard
from paddle_tpu_torch.framework.scope import scope_from_numpy
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.optimizer import MomentumOptimizer as TMomentum

PRUNE_RTOL = 1e-6
PKG = {"jax": (jpkg, jlayers, JProgram, jguard, JMomentum, junique),
       "torch": (tpkg, tlayers, TProgram, tguard, TMomentum, tunique)}


@pytest.fixture
def flags():
    """Set port flags for a test; restore the defaults after it."""
    def set_to(**kw):
        tpkg.set_flags(kw)

    yield set_to
    tpkg.set_flags({"check_nan_inf": False, "benchmark": False,
                    "max_inflight_steps": 2})


def _log_program(which):
    pkg, layers, Program, guard, _, unique = PKG[which]
    main, startup = Program(), Program()
    with unique.guard(), guard(main, startup):
        x = layers.data("x", [3])
        y = layers.log(x)   # log of a negative input -> NaN
        z = layers.scale(y, 2.0)
    return main, startup, z


def _nan_message(which, feed):
    pkg = PKG[which][0]
    main, startup, z = _log_program(which)
    exe = pkg.Executor(pkg.CPUPlace())
    sc = pkg.framework.Scope()
    exe.run(startup, scope=sc)
    pkg.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(RuntimeError) as info:
            exe.run(main, feed=feed, fetch_list=[z], scope=sc)
        out = exe.run(main, feed={"x": np.ones((1, 3), "f4")},
                      fetch_list=[z], scope=sc)
        assert np.isfinite(np.asarray(out[0])).all()
    finally:
        pkg.set_flags({"FLAGS_check_nan_inf": False})
    return str(info.value), exe


def test_flags_and_their_defaults():
    """The port's new flags exist with the JAX package's defaults."""
    names = ["max_inflight_steps", "benchmark", "check_nan_inf",
             "ckpt_async_save", "ckpt_keep_n", "ckpt_fsync",
             "ckpt_verify_restore"]
    assert tpkg.get_flags(names) == jpkg.get_flags(names)
    assert tpkg.get_flags("FLAGS_max_inflight_steps") == \
        {"FLAGS_max_inflight_steps": 2}
    with pytest.raises(KeyError):
        tpkg.set_flags({"FLAGS_no_such_flag": 1})


@pytest.mark.parametrize("cap", [0, 2])
def test_nan_scan_names_the_op_the_jax_package_names(flags, cap):
    """log of a negative input: both packages name op 'log', index 0 of
    the compiled block; under window 2 the raise happens inside the
    offending run, which is no longer in flight."""
    feed = {"x": np.array([[-1.0, 2.0, 3.0]], "f4")}
    want, _ = _nan_message("jax", feed)
    flags(max_inflight_steps=cap)
    got, exe = _nan_message("torch", feed)
    pattern = r"op '(\w+)' \(built at (.+)\) produced NaN/Inf \(op #(\d+)"
    (jt, _, ji), (tt, tsite, ti) = (re.search(pattern, m).groups()
                                     for m in (want, got))
    assert (tt, ti) == (jt, ji) == ("log", "0")
    assert "test_torch_nan_prune.py" in tsite
    assert len(exe._window) == 0


def test_nan_scan_names_the_first_op_across_dtypes(flags):
    """The flags are grouped by dtype on the device: a float16 'log'
    (op #2) that makes NaN before a float32 cast of it (op #3) is the op
    named, as the JAX package names it."""
    msgs = []
    for which in ("jax", "torch"):
        pkg, layers, Program, guard, _, unique = PKG[which]
        main, startup = Program(), Program()
        with unique.guard(), guard(main, startup):
            x = layers.data("x", [3])
            a = layers.scale(x, 2.0)
            b = layers.cast(a, "float16")
            c = layers.log(b)
            d = layers.cast(c, "float32")
        exe = pkg.Executor(pkg.CPUPlace())
        sc = pkg.framework.Scope()
        exe.run(startup, scope=sc)
        pkg.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(RuntimeError) as info:
                exe.run(main, feed={"x": np.array([[-1.0, 2.0, 3.0]], "f4")},
                        fetch_list=[d], scope=sc)
        finally:
            pkg.set_flags({"FLAGS_check_nan_inf": False})
        msgs.append(str(info.value))
    for m in msgs:
        assert re.search(r"op 'log' \(built at .+\) produced NaN/Inf "
                         r"\(op #2 ", m), m


def test_nan_scan_all_pseudo_program(flags):
    """A program with no compiled op: the flags fetch does not leak."""
    main, startup = TProgram(), TProgram()
    with tguard(main, startup):
        x = tlayers.data("x", [3])
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    flags(check_nan_inf=True)
    out = exe.run(main, feed={"x": np.ones((2, 3), "f4")}, fetch_list=[x],
                  scope=sc)
    assert len(out) == 1
    np.testing.assert_array_equal(out[0], np.ones((2, 3)))


def _momentum(which="torch", seed=1):
    pkg, layers, Program, guard, Momentum, unique = PKG[which]
    main, startup = Program(), Program()
    main.random_seed = seed
    with unique.guard(), guard(main, startup):
        x = layers.data("x", [4])
        y = layers.data("y", [1])
        pred = layers.fc(x, 1, bias_attr=False)
        loss = layers.mean(layers.square_error_cost(pred, y))
        Momentum(0.1, 0.9).minimize(loss)
    return main, startup, loss


def _feed():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(8, 4).astype("f4"),
            "y": rs.randn(8, 1).astype("f4")}


@pytest.mark.parametrize("captured", [False, True])
def test_nan_scan_on_the_capture_path_refuses_a_snapshot(flags, monkeypatch,
                                                         captured):
    """The scan inside a captured step (a stand-in StepGraph): a weight
    set to inf makes the next run raise naming 'mul' (the fc's matmul);
    the scope is then refused by snapshot_scope until a restore."""
    from test_torch_executor_graph import _RecordedStep

    monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    main, startup, loss = _momentum()
    exe = tpkg.Executor(tpkg.CPUPlace())
    exe._captures = captured
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    good = snapshot_scope(sc)
    flags(check_nan_inf=True)
    for _ in range(3):   # warm-up, capture, replay
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc)
    w = main.all_parameters()[0].name
    sc.set_var(w, np.full(tuple(sc.get_var(w).shape), np.inf, "f4"))
    with pytest.raises(RuntimeError, match=r"op 'mul' \(built at"):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc)
    if captured:
        entry = next(e for e in exe._cache.values() if e.nan_scan)
        assert entry.graph is not None and entry.nan_ops
    with pytest.raises(CheckpointError, match="NaN scan"):
        snapshot_scope(sc)
    restore_scope(sc, good, device="cpu")
    assert set(snapshot_scope(sc)) == set(good)


def test_use_prune_skips_optimizer_ops():
    """An eval fetch on a training program with use_prune=True leaves the
    parameter and its velocity bit-unchanged; its loss equals the JAX
    package's pruned loss from the same startup values and the port's
    unpruned loss of that state.  The pruned program is cached and keys
    a compiled step of its own."""
    jmain, jstartup, jloss = _momentum("jax")
    jexe = jpkg.Executor(jpkg.CPUPlace())
    jsc = jpkg.framework.Scope()
    jexe.run(jstartup, scope=jsc)
    init = {n: np.asarray(jsc.get_var(n)) for n in jsc.local_var_names()
            if n != "@RNG_KEY@"}
    want = np.asarray(jexe.run(jmain, feed=_feed(), fetch_list=[jloss],
                               scope=jsc, use_prune=True)[0])

    main, _startup, loss = _momentum()
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = scope_from_numpy(init, "cpu")
    before = {n: sc.get_var(n).clone() for n in sc.local_var_names()}
    hits = stat_get("executor_prune_cache_hit")
    l1 = exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc,
                 use_prune=True)[0]
    l1b = exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc,
                  use_prune=True)[0]
    for n, v in before.items():
        assert torch.equal(sc.get_var(n), v), n
    assert stat_get("executor_prune_cache_hit") == hits + 1
    np.testing.assert_array_equal(l1, l1b)
    np.testing.assert_allclose(l1, want, rtol=PRUNE_RTOL)
    l2 = exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc)[0]
    w = main.all_parameters()[0].name
    assert not torch.equal(sc.get_var(w), before[w])
    np.testing.assert_allclose(l1, l2, rtol=PRUNE_RTOL)
    assert len(exe._cache) == 2   # the pruned and the whole program


def test_benchmark_drains_every_run(flags):
    """FLAGS_benchmark: under window 2 every run drains through itself,
    and each run is recorded when it returns."""
    from paddle_tpu_torch.observe import step_stats

    main, startup, loss = _momentum()
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    exe.drain()
    flags(benchmark=True)
    runs = step_stats.step_timer().runs
    for _ in range(3):
        h = exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc)
        assert len(exe._window) == 0 and h._entry.drained
    assert step_stats.step_timer().runs == runs + 3
    flags(max_inflight_steps=0)
    out = exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc,
                  return_numpy=False)
    assert type(out) is list and step_stats.step_timer().runs == runs + 4


def test_only_localsgd_and_pipeline_programs_are_refused(monkeypatch):
    """Auto-checkpoint's environment and the scan no longer raise;
    pipeline programs still raise the later-slice error, and a localsgd
    program is refused by ``run_steps`` (its average runs between
    ``run`` calls), as in the JAX package."""
    main, startup, loss = _momentum()
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc)
    monkeypatch.delenv("PADDLE_RUNNING_ENV")
    main._pipeline = object()
    with pytest.raises(NotImplementedError, match="later slice"):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=sc)
    main._pipeline = None
    main._localsgd = object()
    with pytest.raises(NotImplementedError,
                       match="run_steps does not support localsgd"):
        exe.run_steps(main, feed=_feed(), fetch_list=[loss], scope=sc,
                      steps=2)
    main._localsgd = None
