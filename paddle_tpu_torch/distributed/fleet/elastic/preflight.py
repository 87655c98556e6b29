"""Device preflight with a deadline: probe the device in a subprocess.

PyTorch port of ``paddle_tpu/distributed/fleet/elastic/preflight.py``.
A device that hangs inside your own process leaves nothing to supervise
with, so the probe runs in a CHILD process under ``subprocess`` timeout:
``import torch``, one add on the CUDA card and a synchronize (context
init, a kernel launch, completion), while the parent -- the disagg
autoscaler re-roling a replica -- can never be hung by it.

The verdict is structured, not a string soup:

- ``ok``            probe printed its sentinel; ``platform`` is set.
- ``init_timeout``  the child exceeded ``FLAGS_elastic_preflight_timeout_s``.
- ``compile_error`` the child exited nonzero (or produced no sentinel;
  no CUDA device is one); ``diag`` carries the stderr tail.

Failures retry with exponential backoff (``FLAGS_elastic_backoff_s *
2^k``) up to ``attempts`` — a transiently-held chip (an orphaned worker
still being reaped) recovers without burning the supervisor's restart
budget.  Every attempt lands in the flight recorder
(``elastic/preflight``) and the ``elastic_preflight_*`` metric family.
"""
from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Optional

from ....framework import flags as _flags
from . import chaos as _chaos

__all__ = ["PreflightVerdict", "preflight_device", "DEFAULT_PROBE_CODE",
           "PREFLIGHT_OK", "PREFLIGHT_INIT_TIMEOUT",
           "PREFLIGHT_COMPILE_ERROR"]

PREFLIGHT_OK = "ok"
PREFLIGHT_INIT_TIMEOUT = "init_timeout"
PREFLIGHT_COMPILE_ERROR = "compile_error"

# init + compile + dispatch in one child; the sentinel keeps parsing
# robust against libraries that chat on stdout during import
DEFAULT_PROBE_CODE = (
    "import torch\n"
    "x = torch.zeros(8, device='cuda') + 1\n"
    "torch.cuda.synchronize()\n"
    "assert float(x.sum()) == 8.0\n"
    "print('PREFLIGHT_OK', 'gpu', torch.cuda.get_device_name(0)"
    ".replace(' ', '_'))\n"
)


class PreflightVerdict:
    """Structured outcome of :func:`preflight_device`."""

    __slots__ = ("ok", "verdict", "platform", "diag", "attempts",
                 "elapsed_s")

    def __init__(self, verdict: str, platform: Optional[str] = None,
                 diag: str = "", attempts: int = 1,
                 elapsed_s: float = 0.0):
        self.verdict = verdict
        self.ok = verdict == PREFLIGHT_OK
        self.platform = platform
        self.diag = diag
        self.attempts = int(attempts)
        self.elapsed_s = float(elapsed_s)

    def to_dict(self) -> dict:
        return {"verdict": self.verdict, "ok": self.ok,
                "platform": self.platform, "diag": self.diag,
                "attempts": self.attempts,
                "elapsed_s": round(self.elapsed_s, 3)}

    def __repr__(self) -> str:  # readable in failure records
        return (f"PreflightVerdict({self.verdict!r}, "
                f"platform={self.platform!r}, attempts={self.attempts})")


def _one_probe(probe_code: str, timeout_s: float) -> PreflightVerdict:
    f = _chaos.take("preflight_init_timeout")
    if f is not None:
        return PreflightVerdict(
            PREFLIGHT_INIT_TIMEOUT,
            diag=f"chaos: injected preflight init timeout ({timeout_s}s)")
    try:
        r = subprocess.run([sys.executable, "-c", probe_code],
                           capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return PreflightVerdict(
            PREFLIGHT_INIT_TIMEOUT,
            diag=f"device init did not complete within {timeout_s}s")
    for line in reversed((r.stdout or "").splitlines()):
        if line.startswith("PREFLIGHT_OK"):
            parts = line.split()
            return PreflightVerdict(
                PREFLIGHT_OK,
                platform=parts[1] if len(parts) > 1 else "unknown",
                diag=" ".join(parts[2:]))
    diag = (r.stderr or r.stdout or "no output").strip()[-2000:]
    return PreflightVerdict(
        PREFLIGHT_COMPILE_ERROR,
        diag=f"probe exited {r.returncode}: {diag}")


def preflight_device(attempts: int = 2,
                     timeout_s: Optional[float] = None,
                     backoff_s: Optional[float] = None,
                     probe_code: Optional[str] = None,
                     sleep_fn: Callable[[float], None] = time.sleep
                     ) -> PreflightVerdict:
    """Probe the device up to ``attempts`` times with exponential
    backoff; returns the first ``ok`` verdict, else the last failure.
    ``timeout_s`` / ``backoff_s`` default from
    ``FLAGS_elastic_preflight_timeout_s`` / ``FLAGS_elastic_backoff_s``.
    Never raises — a preflight that cannot even run is a failed
    verdict, not an exception."""
    from ....monitor import stat_add
    from ....observe import flight as _flight

    timeout_s = float(_flags.flag("elastic_preflight_timeout_s")
                      if timeout_s is None else timeout_s)
    backoff_s = float(_flags.flag("elastic_backoff_s")
                      if backoff_s is None else backoff_s)
    code = probe_code or DEFAULT_PROBE_CODE
    attempts = max(int(attempts), 1)
    t0 = time.perf_counter()
    v = PreflightVerdict(PREFLIGHT_COMPILE_ERROR, diag="no attempts made",
                         attempts=0)
    for i in range(attempts):
        try:
            v = _one_probe(code, timeout_s)
        except Exception as e:  # noqa: BLE001 - subprocess machinery broke
            v = PreflightVerdict(
                PREFLIGHT_COMPILE_ERROR,
                diag=f"probe could not run: {type(e).__name__}: {e}")
        v.attempts = i + 1
        v.elapsed_s = time.perf_counter() - t0
        stat_add("elastic_preflight_attempts")
        stat_add(f"elastic_preflight_{v.verdict}")
        _flight.record("elastic/preflight", attempt=i + 1,
                       verdict=v.verdict, platform=v.platform,
                       diag=(v.diag or "")[:300],
                       elapsed_s=round(v.elapsed_s, 3))
        if v.ok:
            return v
        if i + 1 < attempts:
            stat_add("elastic_preflight_retries")
            sleep_fn(backoff_s * (2 ** i))
    return v
