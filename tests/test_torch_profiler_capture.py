"""PyTorch port: anomaly-triggered and continuous profiler capture
(``observe/profiler_capture.py``) and ``profiler.start_profiler`` /
``stop_profiler`` / ``profiler`` / ``cuda_profiler`` against the JAX
package's.

Both capture engines fed the same wall sequences fire at the same step
with the same trigger text, latch and cool down alike (the capture
itself stubbed: the comparison is of the trigger), and ``parse_trace_dir``
agrees on one directory.  On the CPU a real capture writes a
``torch.profiler`` Chrome trace whose events the bundle counts, and the
continuous mode keeps its 2-deep rotation.  The profiler functions keep
the JAX package's messages and directory contract.
"""
import gzip
import json
import os
import threading
import time

import pytest

import paddle_tpu as jpkg
import paddle_tpu_torch as tpkg
from paddle_tpu.monitor import StatRegistry as JStats
from paddle_tpu.observe import profiler_capture as jcap
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.monitor import StatRegistry as TStats
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.observe import profiler_capture as tcap

PKGS = (jpkg, tpkg)
# (name, step walls, cooldown): a spike episode, a second episode after
# re-arming, a sustained one, a slow drift the median follows
SEQUENCES = {
    "one_spike": ([0.010] * 8 + [0.050] + [0.010] * 3, 60.0),
    "two_episodes": ([0.010] * 8 + [0.050, 0.010, 0.010, 0.060], 0.0),
    "two_episodes_cooling": ([0.010] * 8 + [0.050, 0.010, 0.010, 0.060],
                             3600.0),
    "sustained": ([0.010] * 8 + [0.030] * 6, 0.0),
    "drift": ([0.010 * 1.1 ** i for i in range(20)], 0.0),
    "warming_up": ([0.010, 0.090, 0.010, 0.090, 0.010], 0.0),
}


def _quench_slo_burn():
    for reg in (JStats, TStats):
        for name, _v in reg.instance().export():
            if name.startswith("slo_burn_rate_") and name.endswith("_ppm"):
                reg.instance().set(name, 0)


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    _quench_slo_burn()
    for pkg in PKGS:
        pkg.set_flags({"FLAGS_prof_trigger_ratio": 2.0,
                       "FLAGS_prof_capture_s": 0.05,
                       "FLAGS_postmortem_dir": str(tmp_path / "pm")})
    yield
    tcap.reset_capture()
    _quench_slo_burn()
    for pkg in PKGS:
        pkg.set_flags({"FLAGS_prof_trigger_ratio": 0.0,
                       "FLAGS_prof_capture_s": 2.0,
                       "FLAGS_prof_cooldown_s": 60.0,
                       "FLAGS_prof_continuous_s": 0.0,
                       "FLAGS_postmortem_dir": "postmortem"})


def _fires(mod, walls, burn_at=None):
    """(step index, trigger text) of every capture ``mod``'s engine
    starts over ``walls``, the capture stubbed out."""
    eng = mod.CaptureEngine(window=16, warmup=4)
    fired = []
    steps = []
    eng._start_capture = lambda trigger: fired.append((len(steps), trigger))
    for i, w in enumerate(walls):
        if burn_at is not None and i == burn_at:
            reg = JStats if mod is jcap else TStats
            reg.instance().set("slo_burn_rate_ttft_p99_ppm", 2_000_000)
            eng._last_burn_check = 0.0
        eng.on_step(w)
        steps.append(i)
    return fired, eng._latched


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_wall_sequences_fire_like_jax(seq):
    walls, cooldown = SEQUENCES[seq]
    for pkg in PKGS:
        pkg.set_flags({"FLAGS_prof_cooldown_s": cooldown})
    assert _fires(tcap, walls) == _fires(jcap, walls)


def test_slo_burn_fires_like_jax():
    walls = [0.010] * 12
    got = _fires(tcap, walls, burn_at=6)
    _quench_slo_burn()
    assert got == _fires(jcap, walls, burn_at=6)
    assert got[0][0][1] == "slo_burn slo_burn_rate_ttft_p99_ppm"


def test_parse_trace_dir_equals_jax(tmp_path):
    d = tmp_path / "trace"
    (d / "sub").mkdir(parents=True)
    doc = {"traceEvents": [{"name": "a", "ph": "X"}] * 3}
    (d / "1.trace.json").write_text(json.dumps(doc))
    with gzip.open(d / "sub" / "2.trace.json.gz", "wt") as f:
        json.dump(doc, f)
    (d / "broken.trace.json").write_text("{not json")
    (d / "other.pb").write_bytes(b"\0" * 10)
    got = tcap.parse_trace_dir(str(d))
    assert got == jcap.parse_trace_dir(str(d))
    assert got["files"] == 4 and got["trace_events"] == 6
    assert tcap.parse_trace_dir(str(tmp_path / "missing")) == \
        jcap.parse_trace_dir(str(tmp_path / "missing"))


def test_cpu_capture_writes_a_counted_trace(tmp_path):
    """A real anomaly capture on the CPU: a torch.profiler window whose
    Chrome trace lands in the bundle's profiler summary, with the
    phase snapshot."""
    import torch

    eng = tcap.CaptureEngine(window=16, warmup=4)
    for _ in range(6):
        eng.on_step(0.010)
    eng.on_step(0.100)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 0.5:   # host ops inside the window
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert eng.wait(60)
    assert eng.captures == 1 and len(eng.bundles) == 1
    meta = json.load(open(os.path.join(eng.bundles[0], "meta.json")))
    prof = meta["extra"]["profiler"]
    assert prof["files"] == 1 and prof["trace_events"] > 0
    assert os.path.isfile(os.path.join(eng.bundles[0], "phases.json"))
    assert stat_get("prof_captures") >= 1


class _ThreadProbe:
    """A stand-in profiler that records the thread of each call."""

    def __init__(self, calls):
        self.calls = calls

    def start(self):
        self.calls.append(("start", threading.get_ident()))

    def stop(self):
        self.calls.append(("stop", threading.get_ident()))

    def export_chrome_trace(self, path):
        self.calls.append(("export", threading.get_ident()))
        with open(path, "w") as f:
            json.dump({"traceEvents": [{"name": "k", "ph": "X"}]}, f)


def test_window_opens_and_closes_on_the_draining_thread(monkeypatch):
    """The window of a capture starts and stops on the thread whose
    drains fed the trigger (on the card a stop beside that thread's
    graph replays can block both); the capture thread only writes it."""
    calls = []

    def start(trace_dir):
        os.makedirs(trace_dir, exist_ok=True)
        prof = _ThreadProbe(calls)
        prof.start()
        return prof, None

    monkeypatch.setattr(tcap, "_profiler_start", start)
    tpkg.set_flags({"FLAGS_prof_capture_s": 0.2})
    eng = tcap.capture_engine()
    me = threading.get_ident()
    for _ in range(10):
        tcap.on_step_drained(0.010)
    tcap.on_step_drained(0.100)
    assert calls == [("start", me)] and eng._window is not None
    deadline = time.monotonic() + 30
    while eng._window is not None and time.monotonic() < deadline:
        tcap.on_step_drained(0.010)
        time.sleep(0.01)
    assert calls[1] == ("stop", me)
    assert eng.wait(60) and eng.captures == 1
    assert calls[2][0] == "export" and calls[2][1] != me
    meta = json.load(open(os.path.join(eng.bundles[0], "meta.json")))
    assert meta["extra"]["profiler"]["trace_events"] == 1


def test_continuous_mode_keeps_two_windows(tmp_path):
    tpkg.set_flags({"FLAGS_prof_continuous_s": 0.05,
                    "FLAGS_prof_capture_s": 0.01})
    eng = tcap.capture_engine()
    assert eng.start_continuous() and eng.start_continuous()
    n0 = stat_get("prof_continuous_captures")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and \
            stat_get("prof_continuous_captures") - n0 < 3:
        time.sleep(0.05)
    eng.stop_continuous()
    assert stat_get("prof_continuous_captures") - n0 >= 3
    root = tmp_path / "pm" / "prof_continuous"
    assert set(os.listdir(root)) == {"window_0", "window_1"}
    tpkg.set_flags({"FLAGS_prof_continuous_s": 0.0})
    assert not tcap.maybe_start_continuous()


def test_profiler_messages_and_directory_contract(tmp_path, monkeypatch):
    from paddle_tpu import profiler as jprofiler

    for mod in (jprofiler, tprofiler):
        with pytest.raises(RuntimeError, match="^profiler is not running$"):
            mod.stop_profiler()
    out = str(tmp_path / "explicit")
    tprofiler.start_profiler(profile_path=out)
    try:
        with pytest.raises(RuntimeError,
                           match="^profiler is already running$"):
            tprofiler.start_profiler()
    finally:
        assert tprofiler.stop_profiler() == out
    assert tcap.parse_trace_dir(out)["trace_events"] > 0
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", env_dir)
    with tprofiler.cuda_profiler():
        pass
    assert tcap.parse_trace_dir(env_dir)["files"] == 1
    with tprofiler.profiler(profile_path=str(tmp_path / "ctx")):
        with tprofiler.RecordEvent("user/span"):
            pass
    names = {e.get("name") for f in os.listdir(tmp_path / "ctx")
             for e in json.load(open(tmp_path / "ctx" / f))["traceEvents"]}
    assert "user/span" in names
