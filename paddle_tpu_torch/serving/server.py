"""``serving.Server`` (dynamic-batching inference over a ``Predictor``)
and ``DecodeServer`` (N decode replicas behind one admission point) --
PyTorch port of ``paddle_tpu/serving/server.py``.

``Server`` is the serving layer over three pieces the port already has:
the ``inference.Predictor``, the ``Executor``'s compiled-step cache
(warmed per shape bucket by ``Executor.warmup``: on the card each
bucket's step is run once and captured into a CUDA graph on the caller's
thread, and the batcher's worker thread replays it), and
``monitor.StatRegistry`` for runtime counters::

    srv = serving.Server(model_dir, serving.ServingConfig(
        batch_sizes=(1, 2, 4, 8), seq_lens=(16, 32), http_port=0))
    srv.start()                  # warms (captures) every bucket, serves
    outs = srv.infer({"x": x})   # thread-safe, blocks for the result
    srv.stop(drain=True)         # refuse new work, finish the queue

``http_port`` (0: an ephemeral port, read back from ``srv.http_port``)
serves GET ``/stats`` (counter snapshot), ``/health`` (liveness + queue
depth), ``/debug/requests`` (the live in-flight table),
``/debug/request/<id>`` (one request's timeline) and ``/metrics``
(Prometheus text exposition, registered by the fleet KV HTTP server
itself); ``DecodeServer`` adds ``/debug/slo``.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Sequence

from ..monitor import stat_add, stat_get
from .batcher import _UNSET, Batcher, InferenceRequest
from .buckets import BucketSpec, QueueFullError, bucket_feed_specs, \
    feed_plans
from .decode import DecodeConfig, DecodeEngine

logger = logging.getLogger(__name__)


def _debug_request_route(trace_id: str) -> Dict:
    """GET ``/debug/request/<id>``: full timeline JSON for one trace
    (in flight or retained), from the process trace store."""
    from ..observe.request_trace import get_trace_store

    tr = get_trace_store().get(trace_id)
    if tr is None:
        return {"error": f"no trace {trace_id!r} in flight or retained "
                         f"(head-sampled out, or fell off the ring — "
                         f"see FLAGS_request_trace_sample / "
                         f"FLAGS_request_trace_ring)"}
    return tr.to_dict()


class ServingConfig:
    """Knobs for the serving layer (reference Paddle Serving's
    server-config proto, collapsed to what the serving path needs)."""

    def __init__(self,
                 batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 seq_lens: Sequence[int] = None,
                 max_queue: int = 128,
                 batch_window_ms: float = 5.0,
                 default_deadline_ms: Optional[float] = None,
                 pad_value=0,
                 http_port: Optional[int] = None):
        self.bucket_spec = BucketSpec(batch_sizes, seq_lens)
        self.max_queue = int(max_queue)
        self.batch_window_ms = float(batch_window_ms)
        self.default_deadline_ms = default_deadline_ms
        self.pad_value = pad_value
        self.http_port = http_port  # None: no HTTP; 0: ephemeral port


class Server:
    """Batches concurrent ``infer`` calls through one Predictor."""

    def __init__(self, model, config: Optional[ServingConfig] = None):
        from ..inference import Config as InferConfig
        from ..inference import Predictor

        if isinstance(model, Predictor):
            predictor = model
        elif isinstance(model, (InferConfig, str)):
            predictor = Predictor(model)
        else:
            raise TypeError(
                f"model must be a Predictor, inference.Config, or model "
                f"dir path, got {type(model).__name__}")
        self._config = config or ServingConfig()
        self._predictor = predictor
        self._plans = feed_plans(predictor._program,
                                 predictor.get_input_names())
        self._batcher = Batcher(
            self._run_batch, self._plans, self._config.bucket_spec,
            max_queue=self._config.max_queue,
            batch_window_ms=self._config.batch_window_ms,
            default_deadline_ms=self._config.default_deadline_ms,
            pad_value=self._config.pad_value)
        self._kv = None
        self._t_start = None
        self._started = False

    # -- execution -------------------------------------------------------
    def _run_batch(self, feeds):
        # single-threaded by construction (the batcher's one consumer):
        # the Predictor/Executor pair is not re-entrant
        return self._predictor.run(feeds)

    # -- lifecycle -------------------------------------------------------
    def warmup(self) -> int:
        """Warm every bucket's compiled step (on the card: run once and
        capture its graph); returns the count of new cache entries.
        Serving traffic after warmup only ever replays."""
        specs, open_ended = bucket_feed_specs(
            self._plans, self._config.bucket_spec)
        if open_ended:
            logger.warning(
                "serving warmup skipped: the model has dynamic inner "
                "dims but no seq_lens are configured (exact-shape mode "
                "warms per distinct shape, on demand)")
            return 0
        n = self._predictor._exe.warmup(
            self._predictor._program, specs,
            fetch_list=self._predictor._fetch_targets,
            scope=self._predictor._scope)
        stat_add("serving_warmup_compiles", n)
        return n

    def start(self, warmup: bool = True) -> "Server":
        if self._started:
            return self
        if warmup:
            self.warmup()
        self._batcher.start()
        if self._config.http_port is not None:
            from ..distributed.fleet.utils.http_server import KVServer

            self._kv = KVServer(self._config.http_port,
                                routes={"/stats": self.stats,
                                        "/health": self.health,
                                        "/debug/requests":
                                            self.debug_requests,
                                        "/debug/request/":
                                            _debug_request_route})
            self._kv.start()
        self._t_start = time.monotonic()
        self._started = True
        from ..observe import flight as _flight

        _flight.record("serving/start",
                       http_port=self._config.http_port,
                       warmup=bool(warmup))
        return self

    def stop(self, drain: bool = True):
        self._batcher.stop(drain=drain)
        if self._kv is not None:
            self._kv.stop()
            self._kv = None
        self._started = False
        from ..observe import flight as _flight

        _flight.record("serving/stop", drain=bool(drain))

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)  # error exit: don't drain
        return False

    # -- request path ----------------------------------------------------
    def infer(self, feeds: Dict, deadline_ms=_UNSET):
        """Blocking inference; safe to call from many threads.  Returns
        the fetch list with exactly the caller's BATCH rows (batch
        padding is invisible; a fetch that retains a dynamic inner dim
        comes back padded to its seq bucket -- reduce or mask in-model,
        or slice client-side with the request's true length).  Raises
        QueueFullError / DeadlineExceededError / RequestTooLargeError
        per the backpressure contract."""
        return self._batcher.infer(feeds, deadline_ms=deadline_ms)

    def submit(self, feeds: Dict, deadline_ms=_UNSET) -> InferenceRequest:
        """Async variant: returns a future-like InferenceRequest."""
        return self._batcher.submit(feeds, deadline_ms=deadline_ms)

    # -- observability ---------------------------------------------------
    @property
    def http_port(self) -> Optional[int]:
        return self._kv.port if self._kv is not None else None

    def stats(self) -> Dict[str, float]:
        """Snapshot of the serving/executor counters plus derived
        averages."""
        from ..monitor import export_stats

        out = {n: v for n, v in export_stats()
               if n.startswith("serving_") or n.startswith("executor_")
               or n.startswith("cuda_graph_")}
        completed = out.get("serving_completed", 0)
        if completed:
            out["serving_latency_ms_avg"] = round(
                out.get("serving_latency_us_total", 0) / completed / 1e3,
                3)
        batches = out.get("serving_batches", 0)
        if batches:
            out["serving_batch_occupancy_avg"] = round(
                out.get("serving_batched_requests", 0) / batches, 3)
            rows = out.get("serving_batched_rows", 0)
            out["serving_padding_fraction"] = round(
                out.get("serving_padded_rows", 0)
                / max(rows + out.get("serving_padded_rows", 0), 1), 3)
        return out

    def debug_requests(self) -> Dict:
        """Live in-flight request table."""
        rows = self._batcher.debug_requests()
        return {"requests": rows, "n": len(rows)}

    def health(self) -> Dict:
        depth = self._batcher.queue_depth
        return {
            "status": "ok" if self._started else "stopped",
            "queue_depth": depth,
            "queue_capacity": self._config.max_queue,
            "uptime_s": round(time.monotonic() - self._t_start, 3)
            if self._t_start is not None else 0.0,
            "buckets": self._config.bucket_spec.n_buckets(),
            "compiles": stat_get("executor_compile"),
        }


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
    one model's parameters (loaded once from ``weights``; with
    ``draft_model``/``draft_weights`` every replica speculates with the
    one draft).  ``submit``
    routes each request to the replica with the most free slots (ties:
    shortest queue), falling back across replicas when one's queue is
    full.  Sampling is keyed by the request's own seed, so WHICH
    replica serves a request never changes its tokens."""

    def __init__(self, model, weights, config: Optional[DecodeConfig] = None,
                 replicas: int = 1, http_port: Optional[int] = None,
                 draft_model=None, draft_weights=None):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self._config = config or DecodeConfig()
        if weights is not None:
            model.load_weights(weights)
        self._engines = [
            DecodeEngine(model, None, self._config, name=f"replica-{i}",
                         draft_model=draft_model,
                         draft_weights=draft_weights)
            for i in range(replicas)
        ]
        self._http_port = http_port
        self._kv = None
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
        if self._http_port is not None:
            from ..distributed.fleet.utils.http_server import KVServer

            self._kv = KVServer(self._http_port,
                                routes={"/stats": self.stats,
                                        "/health": self.health,
                                        "/debug/requests":
                                            self.debug_requests,
                                        "/debug/request/":
                                            _debug_request_route,
                                        "/debug/slo": self.debug_slo})
            self._kv.start()
        self._t_start = time.monotonic()
        self._started = True
        return self

    def stop(self, drain: bool = True):
        for eng in self._engines:
            eng.stop(drain=drain)
        if self._kv is not None:
            self._kv.stop()
            self._kv = None
        self._started = False

    def __enter__(self) -> "DecodeServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)
        return False

    # -- observability ---------------------------------------------------
    @property
    def http_port(self) -> Optional[int]:
        return self._kv.port if self._kv is not None else None

    def debug_requests(self) -> Dict:
        """GET ``/debug/requests``: replica-tagged live in-flight rows
        across every engine (each row carries its replica name and trace
        id; follow ``/debug/request/<id>`` for the full timeline)."""
        rows = []
        for eng in self._engines:
            rows.extend(eng.debug_requests())
        return {"requests": rows, "n": len(rows),
                "replicas": len(self._engines)}

    def debug_slo(self) -> Dict:
        """GET ``/debug/slo``: objectives, multi-window burn rates,
        budget remaining, and goodput (observe/slo.py snapshot)."""
        from ..observe import slo as _slo

        return _slo.snapshot()

    def stats(self) -> Dict:
        per = [e.stats() for e in self._engines]
        hit = sum(p["prefix_hit_pages"] for p in per)
        total = sum(p["prefix_prompt_pages"] for p in per)
        proposed = sum(p["spec_proposed"] for p in per)
        accepted = sum(p["spec_accepted"] for p in per)
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
            "spec_accept_rate": round(accepted / proposed, 4)
            if proposed else 0.0,
            "spec_proposed": proposed,
            "spec_accepted": accepted,
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
