"""HTTP KV server (reference fleet/utils/http_server.py).

Counterpart of ``paddle_tpu/distributed/fleet/utils/http_server.py``.
RoleMaker's gloo bootstrap in the reference exchanges endpoints through
this KV; in the port it carries the health plane's heartbeats
(``observe/health.py``, ``/metrics/cluster``) and serves the serving
layer's routes.

It also doubles as the serving layer's observability port: ``routes``
maps a path (e.g. ``/stats``, ``/health``) to a zero-arg callable whose
return value is served as JSON — GETs on a registered route never touch
the KV store.  A route key ending in ``/`` is a PREFIX route: it
matches any longer path under it and its callable receives the path
remainder as one argument (``/debug/request/<trace id>``).  A route may instead return ``(bytes, content_type)`` for
non-JSON payloads; every server registers a default ``/metrics`` route
serving the whole counter+histogram registry in Prometheus
text-exposition format (``paddle_tpu_torch.observe``), so any fleet/serving
process is scrape-able out of the box.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit


class KVHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # quiet
        pass

    def _key(self):
        return self.path.lstrip("/")

    def do_GET(self):
        # route match ignores the query string (scrapers send
        # /stats?format=... and cache-busting /health?ts=...)
        path = urlsplit(self.path).path
        route = self.server.routes.get(path)
        route_arg = None
        if route is not None and path.endswith("/"):
            # an exact GET of a prefix-route key is the empty-remainder
            # case — the handler expects its one argument
            route_arg = ""
        if route is None:
            # prefix routes: a key ending in "/" matches any longer
            # path under it and the handler receives the remainder
            # (e.g. "/debug/request/" -> route("<trace id>"));
            # longest prefix wins
            for rp in sorted(self.server.routes, key=len, reverse=True):
                if rp.endswith("/") and path.startswith(rp) \
                        and len(path) > len(rp):
                    route, route_arg = self.server.routes[rp], \
                        path[len(rp):]
                    break
        if route is not None:
            ctype = "application/json"
            try:
                payload = route(route_arg) if route_arg is not None \
                    else route()
                if isinstance(payload, tuple):  # (body, content_type)
                    payload, ctype = payload
                body = payload if isinstance(payload, bytes) \
                    else json.dumps(payload).encode()
                code = 200
            except Exception as e:  # surface handler bugs as 500s
                body = json.dumps({"error": f"{type(e).__name__}: {e}"}
                                  ).encode()
                ctype = "application/json"
                code = 500
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        with self.server.kv_lock:
            val = self.server.kv.get(self._key())
        if val is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        with self.server.kv_lock:
            self.server.kv[self._key()] = data
        self.send_response(200)
        self.end_headers()

    do_POST = do_PUT

    def do_DELETE(self):
        with self.server.kv_lock:
            self.server.kv.pop(self._key(), None)
        self.send_response(200)
        self.end_headers()


def _metrics_route():
    """Default GET /metrics handler: Prometheus text exposition of the
    whole StatRegistry + histogram registry (observe/histogram.py).
    SLO burn/goodput gauges are re-evaluated per scrape — they
    otherwise refresh only on terminal requests, and a gauge frozen at
    its last-burst peak would never resolve an alert."""
    from ....observe import slo as _slo
    from ....observe.histogram import prometheus_text

    try:
        _slo.refresh_gauges()
    except Exception:  # noqa: BLE001 — the exposition must still serve
        pass
    return (prometheus_text().encode(),
            "text/plain; version=0.0.4; charset=utf-8")


class KVHTTPServer(ThreadingHTTPServer):
    def __init__(self, port, handler=KVHandler, routes=None):
        super().__init__(("", port), handler)
        self.kv = {}
        self.kv_lock = threading.Lock()
        self.routes = dict(routes or {})
        # every fleet/serving HTTP port is scrape-able; pass an explicit
        # "/metrics" route to override (or map it to None to disable —
        # a None route falls through to the KV store)
        self.routes.setdefault("/metrics", _metrics_route)
        if self.routes.get("/metrics") is None:
            del self.routes["/metrics"]

    def kv_snapshot(self, prefix: str = "") -> dict:
        """Consistent copy of the KV store (optionally filtered by key
        prefix) — the read path for aggregating routes like the
        cluster-health ``/metrics/cluster`` (observe/health.py), which
        must not hold the KV lock while rendering."""
        with self.kv_lock:
            if not prefix:
                return dict(self.kv)
            return {k: v for k, v in self.kv.items()
                    if k.startswith(prefix)}


class KVServer:
    """Reference KVServer: start/stop a background KV HTTP server."""

    def __init__(self, port, size=None, routes=None):
        self.http_server = KVHTTPServer(port, KVHandler, routes=routes)
        self.listen_thread = None

    def add_route(self, path: str, fn) -> None:
        """Register ``path`` to serve ``fn()`` as JSON on GET."""
        self.http_server.routes[path] = fn

    def kv_snapshot(self, prefix: str = "") -> dict:
        """Copy of the KV store, optionally filtered by key prefix."""
        return self.http_server.kv_snapshot(prefix)

    @property
    def port(self):
        return self.http_server.server_address[1]

    def start(self):
        self.listen_thread = threading.Thread(
            target=self.http_server.serve_forever, daemon=True)
        self.listen_thread.start()

    def stop(self):
        self.http_server.shutdown()
        if self.listen_thread is not None:
            self.listen_thread.join()
        self.http_server.server_close()
