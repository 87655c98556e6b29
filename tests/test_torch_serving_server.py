"""PyTorch port: the one-shot ``serving.Server`` over ``Predictor``, its
dynamic micro-batcher and the shape-bucket feed planning.

One padding-invariant variable-length model (``bench.py``'s serving
model: relu(x @ W) summed over the dynamic seq dim, so padded rows and
positions contribute exactly zero) is built by each package from the same
values and saved; both ``Server``s serve the same requests on the CPU
(``Config().disable_gpu()`` on the port's side), and every request's
output must agree within 1e-5.  The feed planning (``feed_plans``,
``plan_request``, ``assemble``, ``bucket_feed_specs``) is held to the
JAX functions on the same inputs, and the warmup to the JAX server's
count.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest

import paddle_tpu as jpkg
import paddle_tpu_torch as tpkg
from paddle_tpu import layers as jlayers
from paddle_tpu import serving as jserving
from paddle_tpu.fluid import io as jio
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.program import Program as JProgram
from paddle_tpu.framework.program import program_guard as jguard
from paddle_tpu.serving import buckets as jbuckets
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import serving
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.executor import Executor
from paddle_tpu_torch.framework.place import CPUPlace
from paddle_tpu_torch.framework.program import Program, program_guard
from paddle_tpu_torch.framework.scope import scope_from_numpy
from paddle_tpu_torch.monitor import stat_get, stat_reset
from paddle_tpu_torch.serving import buckets

TOL = 1e-5
BATCH_SIZES = (1, 2, 4, 8)
SEQ_LENS = (8, 16)
N_BUCKETS = len(BATCH_SIZES) * len(SEQ_LENS)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    main, startup = JProgram(), JProgram()
    main.random_seed = 7
    with junique.guard(), jguard(main, startup):
        x = jlayers.data("x", [-1, 4])  # declared [-1, -1, 4]
        h = jlayers.fc(x, 8, num_flatten_dims=2, act="relu",
                       bias_attr=False)
        out = jlayers.reduce_sum(h, dim=1)
    jscope = jpkg.framework.Scope()
    jexe = jpkg.Executor(jpkg.CPUPlace())
    jexe.run(startup, scope=jscope)
    values = {n: np.asarray(jscope.get_var(n))
              for n in jscope.local_var_names()
              if jscope.get_var(n) is not None and not n.startswith("@")}
    with jpkg.fluid.scope_guard(jscope):
        jio.save_inference_model(str(root / "jax"), ["x"], [out], jexe, main)
    tmain, tstart = Program(), Program()
    with tunique.guard(), program_guard(tmain, tstart):
        x = tlayers.data("x", [-1, 4])
        h = tlayers.fc(x, 8, num_flatten_dims=2, act="relu",
                       bias_attr=False)
        tout = tlayers.reduce_sum(h, dim=1)
    with tpkg.fluid.scope_guard(scope_from_numpy(values, device="cpu")):
        tio.save_inference_model(str(root / "torch"), ["x"], [tout],
                                 Executor(CPUPlace()), tmain)
    return {"jax": str(root / "jax"), "torch": str(root / "torch"),
            "program": tmain}


def _config(model_dir):
    cfg = tinference.Config(model_dir)
    cfg.disable_gpu()
    return cfg


def _servers(model_dirs, **over):
    kw = dict(batch_sizes=BATCH_SIZES, seq_lens=SEQ_LENS,
              batch_window_ms=30.0, max_queue=64)
    kw.update(over)
    return (serving.Server(_config(model_dirs["torch"]),
                           serving.ServingConfig(**kw)),
            jserving.Server(model_dirs["jax"], jserving.ServingConfig(**kw)))


def _requests(n=24, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(1 + rs.randint(4), 1 + rs.randint(SEQ_LENS[-1]),
                     4).astype("f4") for _ in range(n)]


def _concurrently(srv, reqs):
    out, errs = [None] * len(reqs), []

    def client(i):
        try:
            out[i] = srv.infer({"x": reqs[i]})
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return out


def test_feed_planning_equals_jax(model_dirs):
    prog = model_dirs["program"]
    plans = buckets.feed_plans(prog, ["x"])
    from paddle_tpu.inference import Config, create_predictor

    jpred = create_predictor(Config(model_dirs["jax"]))
    jplans = jbuckets.feed_plans(jpred._program, ["x"])
    assert plans == jplans
    spec, jspec = buckets.BucketSpec(BATCH_SIZES, SEQ_LENS), \
        jbuckets.BucketSpec(BATCH_SIZES, SEQ_LENS)
    assert buckets.bucket_feed_specs(plans, spec) == \
        jbuckets.bucket_feed_specs(jplans, jspec)
    assert buckets.bucket_feed_specs(plans, buckets.BucketSpec((1, 2))) == \
        jbuckets.bucket_feed_specs(jplans, jbuckets.BucketSpec((1, 2)))
    reqs = [{"x": r.astype("f8")} for r in _requests(4, seed=3)]
    planned = [buckets.plan_request(r, plans, spec) for r in reqs]
    jplanned = [jbuckets.plan_request(r, jplans, jspec) for r in reqs]
    for (a, n, k), (ja, jn, jk) in zip(planned, jplanned):
        assert (n, k) == (jn, jk) and a["x"].dtype == np.float32
        np.testing.assert_array_equal(a["x"], ja["x"])

    class _Req:
        def __init__(self, arrays, nrows):
            self.feeds, self.nrows = arrays, nrows
    key = planned[0][2]
    group = [_Req(a, n) for a, n, k in planned if k == key]
    got = buckets.assemble(group, key, spec, pad_value=0)
    want = jbuckets.assemble(group, key, jspec, pad_value=0)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0]["x"], want[0]["x"])


def test_server_outputs_equal_jax_server(model_dirs):
    reqs = _requests()
    srv, jsrv = _servers(model_dirs)
    stat_reset()
    srv.start()
    jsrv.start()
    try:
        got = _concurrently(srv, reqs)
        want = _concurrently(jsrv, reqs)
    finally:
        srv.stop()
        jsrv.stop()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=0, atol=TOL)
    assert stat_get("serving_completed") == len(reqs)
    assert stat_get("serving_max_batch_occupancy") > 1
    assert stat_get("serving_batches") < len(reqs)
    st = srv.stats()
    assert 0 < st["serving_padding_fraction"] < 1
    assert srv.health()["buckets"] == N_BUCKETS


def test_warmup_count_equals_jax(model_dirs):
    srv, jsrv = _servers(model_dirs)
    n, jn = srv.warmup(), jsrv.warmup()
    assert n == jn == N_BUCKETS
    assert srv.warmup() == jsrv.warmup() == 0     # every bucket cached
    # traffic after warmup adds no entry
    stat_reset()
    srv.start(warmup=False)
    try:
        _concurrently(srv, _requests(8, seed=5))
    finally:
        srv.stop()
    assert stat_get("executor_compile") == 0
    assert len(srv._predictor._exe._cache) == N_BUCKETS


def test_queue_full_backpressure(model_dirs):
    srv, _j = _servers(model_dirs, max_queue=3)
    srv.start()
    try:
        srv._batcher.pause()
        pending = [srv.submit({"x": np.ones((1, 3, 4), "f4")})
                   for _ in range(3)]
        with pytest.raises(serving.QueueFullError):
            srv.submit({"x": np.ones((1, 3, 4), "f4")})
        srv._batcher.resume()
        for r in pending:
            assert r.result(timeout=60)[0].shape == (1, 8)
    finally:
        srv.stop()


def test_deadline_exceeded(model_dirs):
    srv, _j = _servers(model_dirs, batch_window_ms=300.0)
    srv.start()
    try:
        with pytest.raises(serving.DeadlineExceededError):
            srv.infer({"x": np.ones((1, 3, 4), "f4")}, deadline_ms=0.0)
        srv._batcher.pause()
        req = srv.submit({"x": np.ones((1, 3, 4), "f4")}, deadline_ms=30.0)
        with pytest.raises(serving.DeadlineExceededError):
            req.result()
        srv._batcher.resume()
        assert srv.infer({"x": np.ones((2, 3, 4), "f4")})[0].shape == (2, 8)
    finally:
        srv.stop()


def test_request_too_large_and_contract_violations(model_dirs):
    srv, _j = _servers(model_dirs)
    srv.start()
    try:
        with pytest.raises(serving.RequestTooLargeError):
            srv.infer({"x": np.ones((9, 3, 4), "f4")})    # batch > 8
        with pytest.raises(serving.RequestTooLargeError):
            srv.infer({"x": np.ones((1, 17, 4), "f4")})   # seq > 16
        with pytest.raises(ValueError):
            srv.infer({"x": np.ones((1, 3, 5), "f4")})    # fixed dim
        with pytest.raises(KeyError):
            srv.infer({"not_x": np.ones((1, 3, 4), "f4")})
    finally:
        srv.stop()
    with pytest.raises(serving.ServerClosedError):
        srv.submit({"x": np.ones((1, 3, 4), "f4")})


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def test_drain_restart_and_http_port(model_dirs):
    srv, _j = _servers(model_dirs)
    srv.start()
    pending = [srv.submit({"x": np.ones((1, 5, 4), "f4")})
               for _ in range(4)]
    srv.stop(drain=True)
    for r in pending:
        assert r.result()[0].shape == (1, 8)
    srv.start()
    try:
        assert srv.infer({"x": np.ones((2, 3, 4), "f4")})[0].shape == (2, 8)
        assert srv.health()["status"] == "ok"
        assert srv.debug_requests()["n"] == 0
    finally:
        srv.stop()
    # the HTTP routes on an ephemeral port, the same data as the methods
    srv = serving.Server(_config(model_dirs["torch"]),
                         serving.ServingConfig(http_port=0))
    srv.start(warmup=False)
    try:
        port = srv.http_port
        base = f"http://127.0.0.1:{port}"
        assert _get(f"{base}/health")["status"] == "ok"
        assert _get(f"{base}/debug/requests") == {"requests": [], "n": 0}
        assert isinstance(_get(f"{base}/stats"), dict)
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            assert b"# TYPE paddle_tpu_" in r.read()
        assert "error" in _get(f"{base}/debug/request/nope")
    finally:
        srv.stop()
    assert srv.http_port is None


def test_warmup_first_keeps_the_weight_quant_carriers(model_dirs):
    """``Server.warmup`` before any run applies the graph passes outside
    the executor's state-neutral window: the int8 carriers the
    weight-quant pass writes stay in the scope for the traffic after it
    (before, the restore dropped them and every later new entry failed)."""
    from paddle_tpu_torch.framework import flags

    reqs = _requests(6, seed=7)
    flags.set_flags({"weight_quant": "int8"})
    try:
        n0 = stat_get("pass_weight_quant_ops")
        srv, _j = _servers(model_dirs)
        assert srv.warmup() == N_BUCKETS
        assert stat_get("pass_weight_quant_ops") > n0
        scope = srv._predictor._scope
        assert any("@WQ" in n for n in scope.local_var_names())
        srv.start(warmup=False)
        try:
            got = _concurrently(srv, reqs)
        finally:
            srv.stop()
        bare = tinference.create_predictor(_config(model_dirs["torch"]))
        want = [bare.run({"x": r}) for r in reqs]
    finally:
        flags.set_flags({"weight_quant": ""})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=TOL)
