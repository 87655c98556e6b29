"""``fleet.elastic`` -- PyTorch port of the fault injection
(:mod:`.chaos`) and the subprocess device preflight (:mod:`.preflight`)
of ``paddle_tpu/distributed/fleet/elastic``.  The elastic supervisor
waits for a later slice of the port (ROADMAP.md, Queue A item 8)."""
from __future__ import annotations

from . import chaos
from .chaos import RankKilled, TornCheckpoint
from .preflight import PreflightVerdict, preflight_device

__all__ = ["PreflightVerdict", "RankKilled", "TornCheckpoint", "chaos",
           "preflight_device"]
