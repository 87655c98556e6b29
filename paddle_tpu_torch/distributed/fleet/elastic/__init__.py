"""``fleet.elastic`` — preemption-proof elastic training.

PyTorch port of ``paddle_tpu/distributed/fleet/elastic``: subprocess
device preflight with a deadline (:mod:`.preflight`), a supervised step
loop under the stall watchdog and the cluster health plane, with
failure classification and elastic restore on the surviving topology
(:mod:`.supervisor`), and injectable faults so every recovery path is
rehearsed (:mod:`.chaos`).  Flags: ``FLAGS_elastic_max_restarts`` /
``FLAGS_elastic_preflight_timeout_s`` / ``FLAGS_elastic_backoff_s``.
"""
from __future__ import annotations

from . import chaos
from .chaos import RankKilled, TornCheckpoint
from .preflight import (DEFAULT_PROBE_CODE, PREFLIGHT_COMPILE_ERROR,
                        PREFLIGHT_INIT_TIMEOUT, PREFLIGHT_OK,
                        PreflightVerdict, preflight_device)
from .supervisor import (FAILURE_POISON, FAILURE_TOPOLOGY,
                         FAILURE_TRANSIENT, DeadRankDetected,
                         ElasticSupervisor, ElasticTerminated,
                         PreflightError, StallDetected, SupervisorResult,
                         Topology, classify_failure,
                         dead_ranks_from_cluster, is_device_failure)

__all__ = [
    "ElasticSupervisor", "SupervisorResult", "Topology",
    "ElasticTerminated", "PreflightError", "StallDetected",
    "DeadRankDetected", "RankKilled", "TornCheckpoint",
    "preflight_device", "PreflightVerdict", "DEFAULT_PROBE_CODE",
    "PREFLIGHT_OK", "PREFLIGHT_INIT_TIMEOUT", "PREFLIGHT_COMPILE_ERROR",
    "classify_failure", "is_device_failure", "dead_ranks_from_cluster",
    "FAILURE_TRANSIENT", "FAILURE_TOPOLOGY", "FAILURE_POISON", "chaos",
]
