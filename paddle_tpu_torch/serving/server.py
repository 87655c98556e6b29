"""``DecodeServer``: N decode replicas behind one admission point --
PyTorch port of ``DecodeServer`` and ``least_loaded_order`` in
``paddle_tpu/serving/server.py``.

The HTTP routes (``/stats``, ``/health``, ``/metrics``, ``/debug/*``)
ride the fleet KV HTTP server in the JAX package and wait for a later
slice here: ``http_port`` raises ``NotImplementedError``; the same
data is on :meth:`DecodeServer.stats`, :meth:`DecodeServer.health`,
:meth:`DecodeServer.debug_requests` and :meth:`DecodeServer.debug_slo`.
The one-shot bucket ``Server`` waits for the static-graph slice.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from .buckets import QueueFullError
from .decode import DecodeConfig, DecodeEngine, _later_slice


def least_loaded_order(engines):
    """Deterministic least-loaded dispatch order over decode engines:
    most free slots first, then shortest queue, then LOWEST index (so
    router A/Bs are reproducible run-to-run)."""
    engines = list(engines)
    order = sorted(range(len(engines)),
                   key=lambda i: (-engines[i].free_slots,
                                  engines[i].queue_depth, i))
    return [engines[i] for i in order]


class DecodeServer:
    """N replicated decode engines behind ONE admission point with
    least-loaded dispatch.  Every replica is a full ``DecodeEngine``
    with its own slot batch, paged KV cache and thread, all reading the
    one model's parameters (loaded once from ``weights``).  ``submit``
    routes each request to the replica with the most free slots (ties:
    shortest queue), falling back across replicas when one's queue is
    full.  Sampling is keyed by the request's own seed, so WHICH
    replica serves a request never changes its tokens."""

    def __init__(self, model, weights, config: Optional[DecodeConfig] = None,
                 replicas: int = 1, http_port: Optional[int] = None,
                 draft_model=None, draft_weights=None):
        if http_port is not None:
            raise _later_slice("the HTTP routes of DecodeServer "
                               "(http_port=)")
        if draft_model is not None or draft_weights is not None:
            raise _later_slice("speculative decoding (draft_model=)")
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self._config = config or DecodeConfig()
        if weights is not None:
            model.load_weights(weights)
        self._engines = [
            DecodeEngine(model, None, self._config, name=f"replica-{i}")
            for i in range(replicas)
        ]
        self._t_start = None
        self._started = False

    @property
    def replicas(self):
        return list(self._engines)

    # -- request path ----------------------------------------------------
    def submit(self, prompt, **kw):
        last_err = None
        for eng in least_loaded_order(self._engines):
            try:
                return eng.submit(prompt, **kw)
            except QueueFullError as e:
                last_err = e
        raise last_err

    def generate(self, prompt, **kw):
        return self.submit(prompt, **kw).result()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "DecodeServer":
        if self._started:
            return self
        for eng in self._engines:
            eng.start()
        self._t_start = time.monotonic()
        self._started = True
        return self

    def stop(self, drain: bool = True):
        for eng in self._engines:
            eng.stop(drain=drain)
        self._started = False

    def __enter__(self) -> "DecodeServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)
        return False

    # -- observability ---------------------------------------------------
    def debug_requests(self) -> Dict:
        """Replica-tagged live in-flight rows across every engine."""
        rows = []
        for eng in self._engines:
            rows.extend(eng.debug_requests())
        return {"requests": rows, "n": len(rows),
                "replicas": len(self._engines)}

    def debug_slo(self) -> Dict:
        """Objectives, multi-window burn rates, budget remaining, and
        goodput (observe/slo.py snapshot)."""
        from ..observe import slo as _slo

        return _slo.snapshot()

    def stats(self) -> Dict:
        per = [e.stats() for e in self._engines]
        hit = sum(p["prefix_hit_pages"] for p in per)
        total = sum(p["prefix_prompt_pages"] for p in per)
        slo_snap = self.debug_slo()
        return {
            "goodput_rps": slo_snap.get("goodput_rps", 0.0),
            "slo_violations": slo_snap.get("violations_total", 0),
            "replicas": per,
            "n_replicas": len(per),
            "tokens_total": sum(p["tokens_total"] for p in per),
            "live_slots": sum(p["live_slots"] for p in per),
            "free_slots": sum(p["free_slots"] for p in per),
            "queue_depth": sum(p["queue_depth"] for p in per),
            "cache_hit_rate": round(hit / total, 4) if total else 0.0,
            "shared_pages": sum(p["shared_pages"] for p in per),
            "cow_copies": sum(p["cow_copies"] for p in per),
            "prefill_chunks": sum(p["prefill_chunks"] for p in per),
            "kv_quant": all(p["kv_quant"] for p in per) if per
            else False,
            "cache_bytes": sum(p["cache_bytes"] for p in per),
        }

    def health(self) -> Dict:
        return {
            "status": "ok" if self._started else "stopped",
            "replicas": len(self._engines),
            "free_slots": sum(e.free_slots for e in self._engines),
            "queue_depth": sum(e.queue_depth for e in self._engines),
            "uptime_s": round(time.monotonic() - self._t_start, 3)
            if self._t_start is not None else 0.0,
        }
