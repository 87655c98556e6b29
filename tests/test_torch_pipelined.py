"""PyTorch port: the executor's pipelined window (``StepHandle``,
``FLAGS_max_inflight_steps``), held to the JAX package's contracts
(``tests/test_pipelined_dispatch.py``).

Tolerances: the JAX package and the port train the same momentum
program from one startup (the JAX package's values) within 1e-5 on the
losses (float32, the same arithmetic in other summation orders); its
dropout rate is 0 there, since the two packages' generators draw
different masks.  The port against itself, with dropout 0.3 drawing
from the scope's generator: window 0 and window 2 bit-equal in losses
and in the final state, the generator's included, on the plain path and
on the capture path (a stand-in ``StepGraph`` whose replay reruns the
recorded step, as in ``test_torch_executor_graph.py``).
"""
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
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.observe.histogram import histogram as thistogram
from paddle_tpu_torch.observe import step_stats as tstep_stats
from paddle_tpu_torch.ckpt import snapshot_scope
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.executor import StepHandle, _InflightStep
from paddle_tpu_torch.framework.program import Program as TProgram
from paddle_tpu_torch.framework.program import program_guard as tguard
from paddle_tpu_torch.framework.scope import scope_from_numpy
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.optimizer import MomentumOptimizer as TMomentum

JAX_TOL = 1e-5


@pytest.fixture
def window():
    """Set FLAGS_max_inflight_steps for a test; restore the default."""

    def set_to(n):
        tpkg.set_flags({"FLAGS_max_inflight_steps": n})

    yield set_to
    tpkg.set_flags({"FLAGS_max_inflight_steps": 2})


def _model(layers, unique, program, guard, momentum, dropout, seed=3):
    """fc -> dropout -> fc, MSE, Momentum: parameters, velocity slots
    and (dropout > 0) the generator are live state."""
    main, startup = program(), program()
    main.random_seed = seed
    with unique.guard(), guard(main, startup):
        x = layers.data("x", [8])
        y = layers.data("y", [1])
        h = layers.fc(x, 16, act="relu")
        h = layers.dropout(h, dropout,
                           dropout_implementation="upscale_in_train")
        pred = layers.fc(h, 1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        momentum(0.05, 0.9).minimize(loss)
    return main, startup, loss


def _tmodel(dropout=0.3):
    return _model(tlayers, tunique, TProgram, tguard, TMomentum, dropout)


def _batches(n_steps, batch=16):
    rs = np.random.RandomState(0)
    X = rs.randn(n_steps, batch, 8).astype("f4")
    Y = X.sum(2, keepdims=True).astype("f4") * 0.3
    return [(X[i], Y[i]) for i in range(n_steps)]


def _startup_values():
    """The JAX package's startup values of the dropout-0 program."""
    main, startup, _ = _model(jlayers, junique, JProgram, jguard,
                              JMomentum, 0.0)
    exe = jpkg.Executor(jpkg.CPUPlace())
    sc = jpkg.framework.Scope()
    exe.run(startup, scope=sc)
    return {n: np.asarray(sc.get_var(n)) for n in sc.local_var_names()
            if n != "@RNG_KEY@"}


def _train(window, cap, n_steps=8, dropout=0.3, init=None, captured=False,
           monkeypatch=None):
    """Port train loop at window ``cap``; returns (losses, final state,
    executor).  Handles are read only after every step was dispatched."""
    window(cap)
    if captured:
        from test_torch_executor_graph import _RecordedStep

        monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    main, startup, loss = _tmodel(dropout)
    exe = tpkg.Executor(tpkg.CPUPlace())
    exe._captures = captured
    if init is None:
        sc = tpkg.framework.Scope()
        exe.run(startup, scope=sc)
    else:
        sc = scope_from_numpy(init, "cpu")
    handles = [exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss],
                       scope=sc) for bx, by in _batches(n_steps)]
    losses = [float(h[0].ravel()[0]) for h in handles]
    exe.drain()
    return losses, snapshot_scope(sc), exe


def _same_state(a, b):
    assert set(a) == set(b)
    for n in a:
        if isinstance(a[n], torch.Tensor):
            assert torch.equal(a[n], b[n]), n
        else:   # the generator
            assert torch.equal(a[n].state, b[n].state), n


@pytest.mark.parametrize("captured", [False, True])
def test_window_0_and_2_are_bit_equal(window, monkeypatch, captured):
    """8 momentum steps with dropout 0.3: the pipelined run (window 2)
    is bit-equal to the synchronous one (window 0), losses and final
    state (parameters, velocities, the generator)."""
    sync_l, sync_s, _ = _train(window, 0, captured=captured,
                               monkeypatch=monkeypatch)
    pipe_l, pipe_s, exe = _train(window, 2, captured=captured,
                                 monkeypatch=monkeypatch)
    assert sync_l == pipe_l
    _same_state(sync_s, pipe_s)
    if captured:
        assert any(e.graph is not None for e in exe._cache.values())


def test_losses_agree_with_the_jax_package(window):
    """The same 8-step momentum program (dropout 0) from the JAX
    package's startup values: the JAX losses and the port's at windows 0
    and 2 agree within JAX_TOL."""
    init = _startup_values()
    main, _startup, loss = _model(jlayers, junique, JProgram, jguard,
                                  JMomentum, 0.0)
    exe = jpkg.Executor(jpkg.CPUPlace())
    sc = jpkg.framework.Scope()
    for n, v in init.items():
        sc.set_var(n, v)
    want = [float(np.asarray(exe.run(main, feed={"x": bx, "y": by},
                                     fetch_list=[loss], scope=sc)[0])
                  .ravel()[0]) for bx, by in _batches(8)]
    for cap in (0, 2):
        got = _train(window, cap, dropout=0.0, init=init)[0]
        np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=0)


def test_handle_semantics(window):
    """A StepHandle is a lazy list: items materialize (and cache) on
    access, numpy() gives them all, device_arrays() does not wait, and a
    return_numpy=False handle yields the step's tensors."""
    window(2)
    main, startup, loss = _tmodel()
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    bx, by = _batches(1)[0]
    h = exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss], scope=sc)
    assert isinstance(h, StepHandle) and isinstance(h, list)
    assert len(h) == 1
    raw = h.device_arrays()[0]
    assert isinstance(raw, torch.Tensor) and not h._entry.drained
    v = h[0]
    assert isinstance(v, np.ndarray) and h._entry.drained
    assert h[0] is v and h.numpy()[0] is v
    (only,) = h
    assert only is v
    assert np.asarray(h).shape == (1,) + v.shape
    h2 = exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss],
                 scope=sc, return_numpy=False)
    assert isinstance(h2[0], torch.Tensor)
    assert np.isfinite(h2.numpy()[0]).all()
    exe.drain()
    assert len(exe._window) == 0


def test_backpressure_and_drain_on_read(window):
    """Dispatch pushes until the cap, a dispatch at the cap drains the
    oldest step, reading the newest handle drains everything up to it;
    dispatched and drained counters move by one a step."""
    window(2)
    main, startup, loss = _tmodel()
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    exe.drain()
    d0 = stat_get("executor_steps_dispatched")
    r0 = stat_get("executor_steps_drained")
    bx, by = _batches(1)[0]
    run = lambda: exe.run(main, feed={"x": bx, "y": by},  # noqa: E731
                          fetch_list=[loss], scope=sc)
    h1, h2 = run(), run()
    assert len(exe._window) == 2 and not h1._entry.drained
    assert stat_get("executor_inflight_steps") == 2
    h3 = run()
    assert len(exe._window) == 2 and h1._entry.drained
    assert not h2._entry.drained
    h3.numpy()
    assert len(exe._window) == 0 and h2._entry.drained
    assert stat_get("executor_steps_dispatched") - d0 == 3
    assert stat_get("executor_steps_drained") - r0 == 3
    assert stat_get("executor_inflight_steps_max") >= 2


def test_run_steps_returns_a_handle_equal_to_the_sync_path(window):
    """run_steps(steps=None) over 4 stacked batches: the pipelined
    handle's stacked fetches equal the synchronous call's."""
    outs = {}
    for cap in (0, 2):
        window(cap)
        main, startup, loss = _tmodel()
        exe = tpkg.Executor(tpkg.CPUPlace())
        sc = tpkg.framework.Scope()
        exe.run(startup, scope=sc)
        b = _batches(4)
        out = exe.run_steps(main, feed={"x": np.stack([x for x, _ in b]),
                                        "y": np.stack([y for _, y in b])},
                            fetch_list=[loss], scope=sc, return_numpy=True)
        assert isinstance(out, StepHandle) == (cap > 0)
        outs[cap] = out[0]
    assert outs[0].shape == (4, 1)
    np.testing.assert_array_equal(outs[0], outs[2])


def test_inflight_gauge_sums_across_executors(window):
    """executor_inflight_steps totals every live Executor's window."""
    window(2)
    bx, by = _batches(1)[0]
    exes = []
    for seed in (3, 4):
        main, startup, loss = _model(tlayers, tunique, TProgram, tguard,
                                     TMomentum, 0.3, seed=seed)
        exe = tpkg.Executor(tpkg.CPUPlace())
        sc = tpkg.framework.Scope()
        exe.run(startup, scope=sc)
        exe.drain()
        exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss], scope=sc)
        exes.append(exe)
    texecutor.drain_all()   # other tests' executors may hold steps
    for exe in exes:
        exe._window.push(_InflightStep((), None, None, (), None, 0.0, 1, 0,
                                       False, 0.0))
    assert stat_get("executor_inflight_steps") == 2
    for exe in exes:
        exe.drain()
    assert stat_get("executor_inflight_steps") == 0


def test_telemetry_drain_parks_failures_for_the_next_raising_point(window):
    """A failure met by StepTimer.summary's drain (raise_errors=False)
    is parked on its window and raised at the next raising drain point,
    exactly once."""
    window(2)
    exe = tpkg.Executor(tpkg.CPUPlace())
    bad = _InflightStep((), None, torch.zeros((1,), dtype=torch.bool),
                        (("log", "<test>", 0),), None, 0.0, 1, 0, False,
                        0.0)
    exe._window.push(bad)
    tstep_stats.step_timer().summary()
    assert len(exe._window) == 0
    with pytest.raises(RuntimeError, match="log"):
        exe.drain()
    exe.drain()


def test_step_timer_summary_drains_the_window(window):
    """StepTimer.summary() reflects completed steps though nothing was
    read: the startup and the first main run are compiles, the other
    three are steps."""
    window(2)
    tstep_stats.reset_step_stats()
    main, startup, loss = _tmodel()
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    for bx, by in _batches(4):
        exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss], scope=sc)
    assert len(exe._window) == 2
    s = tstep_stats.step_timer().summary()
    assert len(exe._window) == 0
    assert s["compiles"] == 2 and s["steps"] == 3
    assert s["step_time_s"]["count"] == 3
    assert thistogram("fetch_sync_seconds").count > 0


def test_device_prefetcher_feeds_a_pipelined_executor(window, monkeypatch):
    """Batches through DevicePrefetcher (its stream, event and pinned copy
    stood in for, as in test_torch_io.py) feed a pipelined executor; the
    losses equal a host-fed synchronous loop's."""

    class Stream:
        def __init__(self, device=None):
            pass

        def wait_event(self, event):
            pass

    class Event:
        def record(self, stream):
            pass

    class Guard:
        def __init__(self, stream):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    X = np.random.RandomState(7).randn(32, 8).astype("f4")
    Y = X.sum(1, keepdims=True).astype("f4") * 0.3
    results = {}
    for mode, (cap, dev) in {"sync": (0, False), "pipe": (2, True)}.items():
        window(cap)
        main, startup, loss = _tmodel()
        exe = tpkg.Executor(tpkg.CPUPlace())
        sc = tpkg.framework.Scope()
        exe.run(startup, scope=sc)
        with monkeypatch.context() as m:
            if dev:
                m.setattr(torch.cuda, "Stream", Stream)
                m.setattr(torch.cuda, "Event", Event)
                m.setattr(torch.cuda, "stream", Guard)
                m.setattr(torch.cuda, "current_stream", lambda d: Stream())
                m.setattr(tio, "prefetch_device",
                          lambda s: torch.device("cpu"))
                m.setattr(torch.Tensor, "pin_memory", lambda t: t.clone())
                m.setattr(torch.Tensor, "record_stream", lambda t, s: None)
            dl = tio.DataLoader(tio.TensorDataset([X, Y]), batch_size=8,
                                shuffle=False, device_prefetch=dev)
            handles = [exe.run(main, feed={"x": bx, "y": by},
                               fetch_list=[loss], scope=sc)
                       for bx, by in dl]
        results[mode] = [float(h[0].ravel()[0]) for h in handles]
        exe.drain()
    assert results["sync"] == results["pipe"]


def test_warmup_and_close_drain_first(window):
    """warmup snapshots a quiescent scope and close() leaves nothing in
    flight; module-level drain_all/close_all reach every executor."""
    window(2)
    main, startup, loss = _tmodel()
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    bx, by = _batches(1)[0]
    exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss], scope=sc)
    assert len(exe._window) > 0
    exe.warmup(main, [{"x": bx, "y": by}], fetch_list=[loss], scope=sc)
    assert len(exe._window) == 0
    exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss], scope=sc)
    exe.close()
    assert len(exe._window) == 0
    exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss], scope=sc)
    assert texecutor.close_all() >= 1
    assert len(exe._window) == 0


def test_windows_under_concurrent_dispatch_and_telemetry_drains(window):
    """Threads that each step their own executor while others drain every
    window (StepTimer.summary's path) lose no step: every step is
    drained once, the gauge ends at 0, and every loss equals a
    single-threaded run's."""
    import sys
    import threading

    window(2)
    bx, by = _batches(1)[0]
    main, startup, loss = _tmodel()
    init = tpkg.Executor(tpkg.CPUPlace())
    sc0 = tpkg.framework.Scope()
    init.run(startup, scope=sc0)
    init.drain()
    start = snapshot_scope(sc0)

    def job(out):
        exe = tpkg.Executor(tpkg.CPUPlace())
        sc = tpkg.framework.Scope()
        for n, v in start.items():
            sc.set_var(n, v.clone() if isinstance(v, torch.Tensor)
                       else v.generator(torch.device("cpu")))
        hs = [exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss],
                      scope=sc) for _ in range(6)]
        out.append([float(h[0].ravel()[0]) for h in hs])
        exe.drain()

    want = []
    job(want)
    d0 = stat_get("executor_steps_dispatched")
    r0 = stat_get("executor_steps_drained")
    outs, stop = [], threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        drainers = [threading.Thread(target=lambda: [
            texecutor.drain_all(raise_errors=False)
            for _ in iter(stop.is_set, True)]) for _ in range(2)]
        workers = [threading.Thread(target=job, args=(outs,))
                   for _ in range(8)]
        for t in drainers + workers:
            t.start()
        for t in workers:
            t.join(timeout=120)
        stop.set()
        for t in drainers:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in drainers + workers)
    assert outs == [want[0]] * 8
    assert stat_get("executor_steps_dispatched") - d0 == 48
    assert stat_get("executor_steps_drained") - r0 == 48
    assert stat_get("executor_inflight_steps") == 0
