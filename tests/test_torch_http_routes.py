"""PyTorch port: the serving HTTP routes, the fleet KV server and the
Chrome trace export against the JAX package's.

``Server`` (the one-shot batching server, on the tiny padding-invariant
model of ``test_torch_serving_server.py``) and ``DecodeServer`` (a
two-layer TransformerLM carrying the JAX model's weights) run in both
packages with ``http_port=0`` over the same requests; every route
answers 200 with the JAX server's JSON keys (``/metrics``: Prometheus
text that parses).  ``chrome_trace`` of the same span records, and of
one request's timeline, equals the JAX package's.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.distributed.fleet.utils import KVServer as JKVServer
from paddle_tpu.monitor import stat_reset as jstat_reset
from paddle_tpu.observe import request_trace as jrt
from paddle_tpu.observe import timeline as jtimeline
from paddle_tpu.observe import tracer as jtracer
from paddle_tpu.serving import decode as jdec
from paddle_tpu.serving import server as jserver
from paddle_tpu_torch.distributed.fleet.utils import KVServer
from paddle_tpu_torch.monitor import stat_reset
from paddle_tpu_torch.observe import request_trace as trt
from paddle_tpu_torch.observe import timeline as ttimeline
from paddle_tpu_torch.observe import tracer as ttracer
from paddle_tpu_torch.serving import DecodeConfig, DecodeServer
from paddle_tpu_torch.serving import TransformerLM, weights_from_numpy
from test_torch_serving_server import (_concurrently, _requests,  # noqa
                                       _servers, model_dirs)

VOCAB = 61
CFG = dict(slots=3, max_seq_len=64, page_size=8, max_new_tokens=6)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [11] * 17]


def _get(port, path):
    """(status, content type, body)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _series(text):
    """Metric names of a Prometheus exposition; raises on a bad line."""
    names = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            names.add(name.split("{", 1)[0])
    return names


def _routes(port, paths):
    """{label: (status, content type, JSON keys, or whether Prometheus
    text parsed)} for ``paths``, each a path or (label, path)."""
    out = {}
    for path in paths:
        label, path = path if isinstance(path, tuple) else (path, path)
        code, ctype, body = _get(port, path)
        if ctype.startswith("text/plain"):
            out[label] = (code, ctype, bool(_series(body.decode())))
        else:
            out[label] = (code, ctype, sorted(json.loads(body)))
    return out


@pytest.fixture(scope="module")
def decode_models():
    import jax

    jmodel = jdec.TransformerLM(vocab_size=VOCAB, d_model=32, num_layers=2,
                                num_heads=2, max_seq_len=64)
    weights = jmodel.init_weights(jax.random.PRNGKey(7))
    host = jax.tree_util.tree_map(np.asarray, weights)
    tmodel = TransformerLM(VOCAB, d_model=32, num_layers=2, num_heads=2,
                           max_seq_len=64, device="cpu")
    tmodel.load_weights(weights_from_numpy(host, "cpu"))
    return (jmodel, weights), tmodel


def test_decode_server_routes_answer_like_jax(decode_models):
    (jmodel, jweights), tmodel = decode_models
    servers = (jserver.DecodeServer(jmodel, jweights,
                                    jdec.DecodeConfig(**CFG), http_port=0),
               DecodeServer(tmodel, None, DecodeConfig(**CFG), http_port=0))
    got, tokens = [], []
    for srv in servers:
        srv.start()
        try:
            reqs = [srv.submit(p) for p in PROMPTS]
            tokens.append([r.result(timeout=120) for r in reqs])
            tid = reqs[0].trace.trace_id
            got.append(_routes(srv.http_port, (
                "/stats", "/health", "/metrics", "/debug/requests",
                ("/debug/request/<id>", f"/debug/request/{tid}"),
                "/debug/request/nope", "/debug/slo")))
        finally:
            srv.stop()
        assert srv.http_port is None
    assert tokens[1] == tokens[0]
    assert got[1] == got[0]
    assert all(v[0] == 200 for v in got[1].values())
    assert "events" in got[1]["/debug/request/<id>"][2]


def test_server_routes_answer_like_jax(model_dirs):
    srv, jsrv = _servers(model_dirs, http_port=0)
    got = []
    for s in (jsrv, srv):
        jstat_reset()
        stat_reset()
        s.start()
        try:
            _concurrently(s, _requests(6, seed=3))
            got.append(_routes(s.http_port, (
                "/health", "/metrics", "/debug/requests",
                "/debug/request/nope")))
            # the counts this traffic fixes (how it batches and pads
            # depends on arrival timing), and the derived averages
            stats = json.loads(_get(s.http_port, "/stats")[2])
            got[-1]["/stats"] = (
                stats["serving_completed"], stats["serving_batched_requests"],
                {"serving_latency_ms_avg", "serving_batch_occupancy_avg",
                 "serving_padding_fraction"} <= set(stats))
        finally:
            s.stop()
        assert s.http_port is None
    want, have = got
    assert have == want
    assert have["/stats"] == (6, 6, True)


def test_kv_server_store_and_routes_like_jax():
    got = []
    for cls in (JKVServer, KVServer):
        srv = cls(0, routes={"/fixed": lambda: {"a": 1},
                             "/p/": lambda rest: {"rest": rest},
                             "/boom": lambda: 1 / 0})
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            req = urllib.request.Request(f"{base}/k/1", data=b"v1",
                                         method="PUT")
            urllib.request.urlopen(req, timeout=10).close()
            out = [_get(srv.port, p) for p in
                   ("/k/1", "/fixed?ts=3", "/p/x/y", "/p/", "/boom",
                    "/missing")]
            out.append(srv.kv_snapshot("k/"))
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/k/1", method="DELETE"), timeout=10).close()
            out.append(_get(srv.port, "/k/1")[0])
        finally:
            srv.stop()
        got.append(out)
    assert got[1] == got[0]


def test_chrome_trace_of_the_same_spans_equals_jax():
    records = [("executor/run", 0.5, 0.75, 11, "MainThread", 0, None,
                {"steps": 1}),
               ("dispatch/drain", 0.6, 0.7, 11, "MainThread", 1,
                "executor/run", None),
               ("serving/batch", 0.1, 0.4, 12, "batcher", 0, None, {})]
    jtracer.clear()
    ttracer.clear()
    want = jtimeline.chrome_trace([jtracer.SpanRecord(*r) for r in records])
    got = ttimeline.chrome_trace([ttracer.SpanRecord(*r) for r in records])
    assert got == want
    assert len(got["traceEvents"]) == 1 + 2 + 3


def test_request_chrome_trace_equals_jax():
    docs = []
    for mod, tracer in ((jrt, jtracer), (trt, ttracer)):
        tracer.clear()
        tr = mod.RequestTrace("abc123", "decode", "replica-0", True,
                              {"prompt_len": 3})
        tr.events.extend([(1.0, "admit", None),
                          (1.5, "prefill_chunk", {"rows": 3}),
                          (2.0, "token", {"n": 1})])
        tr.finish("completed", None, (), {"ttft_s": 0.5})
        tr.events[-1] = (2.5,) + tr.events[-1][1:]   # pin its clock
        docs.append(mod.chrome_trace(tr))
    assert docs[1] == docs[0]
    assert docs[1]["otherData"]["outcome"] == "completed"
