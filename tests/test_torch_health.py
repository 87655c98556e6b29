"""PyTorch port: the health plane (``observe/health.py``) against the
JAX package's.

``cluster_health`` of one KV dict at pinned times equals the JAX
package's, restart epochs included; a postmortem bundle holds the same
section files as the JAX package's, and ``tools/postmortem.py`` renders
it in a subprocess.  The stall watchdog fires once on an executor whose
in-flight step never completes (a stand-in CUDA event), names the
blocked thread, and re-arms after progress; a ``HealthReporter`` beat
reaches a ``KVServer``'s ``/metrics/cluster`` over real localhost HTTP.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as tpkg
from paddle_tpu.observe import health as jhealth
from paddle_tpu.observe import phases as jphases
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.distributed.fleet.utils import KVServer
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.executor import _InflightStep
from paddle_tpu_torch.framework.place import CPUPlace
from paddle_tpu_torch.framework.program import Program, program_guard
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.observe import flight
from paddle_tpu_torch.observe import health as thealth
from paddle_tpu_torch.observe import phases as tphases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_000_000.0


def _beat(rank, age, p50=None, pid=100, dispatched=10, interval=1.0,
          **extra):
    doc = {"rank": rank, "ts": NOW - age, "pid": pid,
           "interval_s": interval, "world_size": 4,
           "dispatched": dispatched, **extra}
    if p50 is not None:
        doc["step_time_p50_s"] = p50
    return json.dumps(doc).encode()


SCRAPES = [
    {"health/rank/0": _beat(0, 0.5, 0.10, hbm_free_bytes=5 << 30),
     "health/rank/1": _beat(1, 0.2, 0.15, comm_exposed_share=0.41,
                            hbm_free_bytes=3 << 30),
     "health/rank/2": _beat(2, 9.0, 0.12),
     "other/key": b"x", "health/rank/x": b"{}"},
    # rank 1 restarted (new pid, counters back), rank 2 came back
    {"health/rank/0": _beat(0, 0.5, 0.10, dispatched=20),
     "health/rank/1": _beat(1, 0.1, 0.30, pid=101, dispatched=1),
     "health/rank/2": _beat(2, 0.3, 0.12, dispatched=11)},
    {"health/rank/0": _beat(0, 0.5, 0.11, dispatched=30),
     "health/rank/1": _beat(1, 0.1, 0.13, pid=101, dispatched=4),
     "health/rank/2": _beat(2, 0.3, 0.12, dispatched=12)},
]


def test_cluster_health_equals_jax():
    jbook, tbook = {}, {}
    for kv in SCRAPES:
        want = jhealth.cluster_health(kv, now=NOW, book=jbook)
        got = thealth.cluster_health(kv, now=NOW, book=tbook)
        assert got == want
    assert got["rank_epochs"] == {"0": 0, "1": 1, "2": 0}
    assert tbook == jbook


def test_bundle_sections_equal_jax(tmp_path):
    jphases.reset_phases()           # no plan left by an earlier test
    tphases.reset_phases()
    jb = jhealth.dump_postmortem("parity", directory=str(tmp_path / "j"),
                                 extra={"k": 1})
    tb = thealth.dump_postmortem("parity", directory=str(tmp_path / "t"),
                                 extra={"k": 1})
    assert sorted(os.listdir(tb)) == sorted(os.listdir(jb))
    jmeta, tmeta = (json.load(open(os.path.join(b, "meta.json")))
                    for b in (jb, tb))
    assert tmeta["section_errors"] == {} == jmeta["section_errors"]
    assert sorted(tmeta) == sorted(jmeta)
    assert sorted(tmeta["progress"]) == sorted(jmeta["progress"])
    for name in ("memory.json", "requests.json", "phases.json"):
        t, j = (json.load(open(os.path.join(b, name))) for b in (tb, jb))
        assert sorted(t) == sorted(j), name


def _tiny_executor():
    main, startup = Program(), Program()
    with tunique.guard(), program_guard(main, startup):
        x = tlayers.data("x", [4])
        loss = tlayers.mean(tlayers.fc(x, 2))
    scope = tpkg.framework.Scope()
    exe = tpkg.Executor(CPUPlace())
    exe.run(startup, scope=scope)

    def run():
        return exe.run(main, feed={"x": np.ones((2, 4), "f4")},
                       fetch_list=[loss], scope=scope)

    return exe, run


class _HungEvent:
    """A CUDA event stand-in for a step the device never finishes:
    ``query`` says not done, ``synchronize`` parks until released."""

    def __init__(self, release):
        self._release = release

    def query(self):
        return self._release.is_set()

    def synchronize(self):
        self._release.wait(timeout=60)


def _hang(exe):
    """Push a hung step into ``exe``'s window and drain it from a named
    thread; returns (release event, drainer thread)."""
    release = threading.Event()
    exe._window.push(_InflightStep(
        [], None, None, (), _HungEvent(release), time.perf_counter(), 1,
        0, False, 0.0))
    drainer = threading.Thread(target=exe.drain, name="hung-train-loop",
                               daemon=True)
    drainer.start()
    return release, drainer


def test_watchdog_fires_once_then_rearms_after_progress(tmp_path):
    exe, run = _tiny_executor()
    run().numpy()
    exe.drain()
    p = thealth.executor_progress()
    assert p["inflight"] == 0 and p["compiling"] is False
    wd = thealth.StallWatchdog(timeout_s=0.4, poll_s=0.05,
                               directory=str(tmp_path))
    wd.start()
    try:
        release, drainer = _hang(exe)
        deadline = time.time() + 15
        while not wd.bundles and time.time() < deadline:
            time.sleep(0.05)
        assert len(wd.bundles) == 1
        time.sleep(0.6)                  # latched: one bundle a stall
        assert len(wd.bundles) == 1
        b = wd.bundles[0]
        meta = json.load(open(os.path.join(b, "meta.json")))
        assert meta["reason"] == "stall"
        assert meta["progress"]["oldest_ready"] is False
        stacks = open(os.path.join(b, "stacks.txt")).read()
        assert "hung-train-loop" in stacks and "synchronize" in stacks
        release.set()
        drainer.join(10)
        assert not drainer.is_alive()
        run().numpy()                    # progress: re-armed
        time.sleep(0.2)
        release, drainer = _hang(exe)
        deadline = time.time() + 15
        while len(wd.bundles) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(wd.bundles) == 2
        release.set()
        drainer.join(10)
    finally:
        wd.stop()
        exe.close()
    assert stat_get("watchdog_stalls") >= 2
    assert any(e["event"] == "health/stall"
               for e in flight.snapshot_events())


def test_cpu_step_in_the_window_is_ready_not_a_stall(tmp_path):
    exe, run = _tiny_executor()
    run().numpy()
    h = run()                            # dispatched, never read
    p = thealth.executor_progress()
    assert p["inflight"] >= 1 and p["oldest_ready"] is True
    wd = thealth.StallWatchdog(timeout_s=0.2, poll_s=0.05,
                               directory=str(tmp_path))
    wd.start()
    time.sleep(0.6)
    wd.stop()
    assert wd.bundles == []
    h.numpy()
    exe.close()


def test_flag_starts_the_watchdog_with_an_executor(tmp_path):
    tpkg.set_flags({"FLAGS_stall_timeout_s": 5.0,
                    "FLAGS_postmortem_dir": str(tmp_path)})
    try:
        tpkg.Executor(CPUPlace())
        wd = thealth.get_watchdog()
        assert wd is not None and wd.running and wd.timeout_s == 5.0
    finally:
        thealth.stop_watchdog()
        tpkg.set_flags({"FLAGS_stall_timeout_s": 0.0,
                        "FLAGS_postmortem_dir": "postmortem"})
    assert thealth.get_watchdog() is None
    with pytest.raises(ValueError, match="timeout_s > 0"):
        thealth.StallWatchdog()


def test_postmortem_cli_renders_a_port_bundle(tmp_path):
    b = thealth.dump_postmortem("cli", directory=str(tmp_path))
    for section in ("stacks.txt", "trace.json", "metrics.prom",
                    "flight.jsonl", "flags.json", "memory.json",
                    "requests.json", "phases.json", "meta.json"):
        assert os.path.isfile(os.path.join(b, section)), section
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "postmortem.py"), b],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr
    assert "cli" in r.stdout


def test_crash_handler_dumps_and_chains(tmp_path):
    seen = []
    prev = sys.excepthook
    sys.excepthook = lambda *a: seen.append(a[0])
    try:
        thealth.install_crash_handler(directory=str(tmp_path))
        try:
            raise KeyError("boom")
        except KeyError:
            sys.excepthook(*sys.exc_info())
    finally:
        thealth.uninstall_crash_handler()
        sys.excepthook = prev
    assert seen == [KeyError]
    bundles = [d for d in os.listdir(tmp_path) if d.startswith("bundle_")]
    meta = json.load(open(tmp_path / bundles[0] / "meta.json"))
    assert meta["reason"] == "crash"
    assert meta["exception"]["type"] == "KeyError"


def test_health_reporter_round_trip_through_a_kv_server():
    srv = KVServer(0)
    srv.start()
    try:
        thealth.serve_cluster_health(srv, world_size=1)
        rep = thealth.HealthReporter(f"127.0.0.1:{srv.port}", rank=0,
                                     world_size=1, interval_s=1.0)
        assert rep.publish_once() and rep.beats == 1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics/cluster",
                timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["alive_ranks"] == 1 and doc["dead_ranks"] == []
        assert doc["ranks"]["0"]["pid"] == os.getpid()
        assert "dispatched" in doc["ranks"]["0"]
        assert srv.kv_snapshot("health/")
    finally:
        srv.stop()
    bad = thealth.HealthReporter("127.0.0.1:1", rank=0, timeout_s=0.5)
    assert bad.publish_once() is False and bad.failures == 1
