"""PyTorch port: TransformerLM, DecodeEngine and DecodeServer.

The JAX package's weights (numpy, from one PRNG key) are carried into
the port with ``weights_from_numpy``, and both engines serve the same
prompts on the CPU: per-step logits must agree within 1e-4 absolute and
greedy tokens must be equal, on the plain, prefix-hit (with a partial
page borrowed and copied on write), chunked-prefill and int8-cache
paths.  Why a tolerance: the JAX engine's logits are bitwise equal to
its own oracle on XLA-CPU, but torch's float32 matmuls and softmax sum
in other orders (1e-6-level differences at these widths, compounded
over two layers).  The port's streamed logits are also held against its
own ``recompute_logits`` within 1e-5 (same library, other row counts).
"""
import ast
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      DecodeServer, TransformerLM,
                                      weights_from_numpy)
from paddle_tpu_torch.serving.buckets import (DeadlineExceededError,
                                              RequestTooLargeError)

VOCAB = 61
JAX_TOL = 1e-4      # port vs JAX engine: float32 summation order
SELF_TOL = 1e-5     # port decode vs port recompute: other row counts
CFG = dict(slots=3, max_seq_len=64, page_size=8, max_new_tokens=8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_model():
    import jax

    model = jdec.TransformerLM(vocab_size=VOCAB, d_model=32, num_layers=2,
                               num_heads=2, max_seq_len=64)
    weights = model.init_weights(jax.random.PRNGKey(7))
    return model, weights, jax.tree_util.tree_map(np.asarray, weights)


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = TransformerLM(VOCAB, d_model=32, num_layers=2, num_heads=2,
                          max_seq_len=64, device="cpu")
    return model.load_weights(weights_from_numpy(jax_model[2], "cpu"))


def _serve(engine, waves, **submit_kw):
    """Submit each wave of prompts, waiting for it before the next (a
    finished request registers its pages for later prefix hits)."""
    engine.start()
    try:
        reqs = []
        for wave in waves:
            batch = [engine.submit(p, record_logits=True, seed=i,
                                   **submit_kw) for i, p in enumerate(wave)]
            for r in batch:
                r.result(timeout=120)
            reqs += batch
    finally:
        engine.stop()
    return reqs


_PATHS = {
    # name: (config overrides, waves of prompts)
    "plain": ({}, [[[1, 2, 3, 4, 5], [9, 8, 7], [11] * 17]]),
    # wave 2: a full-page prefix hit with a suffix prefill, and a prompt
    # wholly covered by the registered pages (partial tail borrowed ->
    # copy-on-write at its first generated token)
    "prefix_hit": ({}, [[list(range(1, 13))],
                        [list(range(1, 9)) + [40, 41, 42, 43, 44],
                         list(range(1, 12))]]),
    "chunked": ({"prefill_chunk_pages": 1},
                [[[3] * 20, [5, 6, 7, 8, 9, 10, 11, 12, 13], [2]]]),
    "kv_int8": ({"kv_quant": True}, [[[1, 2, 3, 4, 5], [9, 8] * 9]]),
}


@pytest.mark.parametrize("path", sorted(_PATHS))
def test_engine_matches_jax_engine(jax_model, port_model, path):
    jm, jw, _ = jax_model
    over, waves = _PATHS[path]
    cfg = dict(CFG, **over)
    jreqs = _serve(jdec.DecodeEngine(jm, jw, jdec.DecodeConfig(**cfg)),
                   waves, max_new_tokens=6)
    teng = DecodeEngine(port_model, None, DecodeConfig(**cfg))
    treqs = _serve(teng, waves, max_new_tokens=6)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated
        assert len(t.logits_trace) == len(j.logits_trace) == 6
        for a, b in zip(t.logits_trace, j.logits_trace):
            np.testing.assert_allclose(a, b, rtol=0, atol=JAX_TOL)
    st = teng.stats()
    if path == "prefix_hit":
        assert st["prefix_hit_pages"] >= 3 and st["cow_copies"] == 1
    if path == "chunked":
        assert st["prefill_chunks"] >= 4
    teng._cache.debug_check()


@pytest.mark.parametrize("path", sorted(_PATHS))
def test_decode_agrees_with_own_recompute(port_model, path):
    over, waves = _PATHS[path]
    eng = DecodeEngine(port_model, None, DecodeConfig(**dict(CFG, **over)))
    reqs = _serve(eng, waves, max_new_tokens=6)
    qz = over.get("kv_quant")
    for r in reqs:
        for i, got in enumerate(r.logits_trace):
            want = eng.recompute_logits(r.prompt + r.generated[:i],
                                        quantized=qz)
            np.testing.assert_allclose(got, want, rtol=0, atol=SELF_TOL)


def test_model_pieces_match_jax(jax_model, port_model):
    import jax.numpy as jnp

    jm, jw, _ = jax_model
    rs = np.random.RandomState(0)
    x = rs.randn(5, 32).astype("f4")
    tx = torch.from_numpy(x)
    lw, tl = jw["layers"][1], port_model.layers[1]
    checks = [
        (jm._ln(jnp.asarray(x), lw["ln1_g"], lw["ln1_b"]),
         port_model._ln(tx, tl.ln1_g, tl.ln1_b)),
        (jm._qkv(lw, jnp.asarray(x))[2], port_model._qkv(tl, tx)[2]),
        (jm._mlp(lw, jnp.asarray(x)), port_model._mlp(tl, tx)),
        (jm._head(jw, jnp.asarray(x)), port_model._head(tx)),
        (jm._embed(jw, jnp.asarray([3, 60]), jnp.asarray([0, 63])),
         port_model._embed(torch.tensor([3, 60]), torch.tensor([0, 63]))),
    ]
    for want, got in checks:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_init_weights_layout_and_distributions(jax_model):
    _, _, npw = jax_model
    m = TransformerLM(VOCAB, d_model=64, num_layers=2, num_heads=4,
                      max_seq_len=64, device="cpu")
    w = m.init_weights(torch.Generator().manual_seed(3))
    assert sorted(w) == sorted(npw)
    assert sorted(w["layers"][0]) == sorted(npw["layers"][0])
    assert w["tok_emb"].shape == (VOCAB, 64)
    assert w["lm_head"].shape == (64, VOCAB)
    # normal x 1/sqrt(fan_in); embeddings x 0.02; LayerNorm ones/zeros
    assert abs(float(w["layers"][0]["w1"].std()) - 1 / 8) < 0.01
    assert abs(float(w["layers"][0]["w2"].std()) - 1 / 16) < 0.005
    assert abs(float(w["tok_emb"].std()) - 0.02) < 0.003
    assert torch.all(w["layers"][1]["ln2_g"] == 1)
    assert torch.all(w["lnf_b"] == 0)
    m.load_weights(w)
    assert torch.equal(m.layers[1].wq, w["layers"][1]["wq"])
    w2 = m.init_weights(torch.Generator().manual_seed(3))
    assert torch.equal(w2["layers"][1]["wo"], w["layers"][1]["wo"])


def test_load_weights_rejects_mismatched_dicts(jax_model):
    _, _, npw = jax_model
    m = TransformerLM(VOCAB, d_model=32, num_layers=2, num_heads=2,
                      max_seq_len=64, device="cpu")
    bad = dict(npw, layers=npw["layers"][:1])
    with pytest.raises(ValueError, match="1 layers"):
        m.load_weights(bad)
    missing = {k: v for k, v in npw.items() if k != "lnf_b"}
    with pytest.raises(RuntimeError, match="lnf_b"):
        m.load_weights(missing)


def test_server_replicas_give_the_same_tokens(port_model):
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8] * 9, [10, 11]]
    kw = dict(max_new_tokens=5, temperature=0.9, top_k=8, top_p=0.95)
    with DecodeServer(port_model, None, DecodeConfig(**CFG),
                      replicas=2) as srv:
        reqs = [srv.submit(p, seed=100 + i, **kw)
                for i, p in enumerate(prompts)]
        two = [r.result(timeout=120) for r in reqs]
        stats = srv.stats()
        assert srv.health()["replicas"] == 2
    assert stats["n_replicas"] == 2 and stats["tokens_total"] == 20
    assert all(r["tokens_total"] > 0 for r in stats["replicas"])
    eng = DecodeEngine(port_model, None, DecodeConfig(**dict(CFG, slots=1)))
    with eng:
        one = [eng.submit(p, seed=100 + i, **kw).result(timeout=120)
               for i, p in enumerate(prompts)]
    assert one == two  # a request's draws depend on its seed alone


def test_sampled_decode_repeats_per_seed(port_model):
    eng = DecodeEngine(port_model, None, DecodeConfig(**CFG))
    kw = dict(max_new_tokens=8, temperature=1.0)
    with eng:
        a = eng.submit([1, 2, 3], seed=5, **kw).result(timeout=120)
        b = eng.submit([1, 2, 3], seed=5, **kw).result(timeout=120)
        c = eng.submit([1, 2, 3], seed=6, **kw).result(timeout=120)
    assert a == b and a != c


def test_streaming_deadline_and_debug_tables(port_model):
    eng = DecodeEngine(port_model, None, DecodeConfig(**CFG))
    seen = []
    with eng:
        r = eng.submit([1, 2, 3, 4], max_new_tokens=5, on_token=seen.append)
        streamed = list(r.tokens(timeout=120))
        assert streamed == r.result(timeout=120) == seen
        assert r.finish_reason == "budget"
        late = eng.submit([1, 2], max_new_tokens=5, deadline_ms=0.0)
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=120)
        with pytest.raises(RequestTooLargeError):
            eng.submit([1] * 60, max_new_tokens=8)
        rows = eng.debug_requests()
    assert isinstance(rows, list)
    st = eng.stats()
    assert st["tokens_total"] == 5 and st["device"] == "cpu"


def _payload(page_size=8, n_tokens=1):
    from paddle_tpu_torch.serving.kv_cache import KVPageExport

    return KVPageExport(n_tokens=n_tokens, n_pages=1, src_pages=[1],
                        arrays={}, quantized=False, page_size=page_size)


def _http_server(m):
    """A DecodeServer on an ephemeral port answers /health, then stops."""
    import json
    import urllib.request

    srv = DecodeServer(m, None, DecodeConfig(**CFG), http_port=0).start()
    try:
        port = srv.http_port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        srv.stop()
    assert srv.http_port is None


# option -> (call, the error it raises now, match).  The options slice 14
# ported raise what the JAX package raises on misuse (``ragged`` has no
# misuse to reject: it now builds an engine, as ``moe`` does since the MoE
# slice, and ``http_port`` serves its routes since the observability
# slice).
_OUT_OF_SLICE = {
    "spec_k": (lambda m: DecodeEngine(m, None, DecodeConfig(
        **CFG, spec_k=2)).submit([1], speculative=True), ValueError,
        "no draft model"),
    "ragged": (lambda m: DecodeEngine(m, None, DecodeConfig(
        **CFG, ragged_prefill_rows=4, prefill_chunk_pages=1)), None, None),
    "draft_model": (lambda m: DecodeEngine(m, None, DecodeConfig(**CFG),
                                           draft_model=m), ValueError,
                    "needs draft_weights"),
    "speculative": (lambda m: DecodeEngine(
        m, None, DecodeConfig(**CFG)).submit([1], speculative=True),
        ValueError, "no draft model"),
    "extract_kv": (lambda m: DecodeEngine(
        m, None, DecodeConfig(**CFG)).submit([1], extract_kv=True,
                                             kv_import=_payload()),
        ValueError, "mutually exclusive"),
    "kv_import": (lambda m: DecodeEngine(
        m, None, DecodeConfig(**CFG)).submit([1], kv_import=_payload(4)),
        ValueError, "page_size"),
    "moe": (lambda m: DecodeEngine(TransformerLM(
        VOCAB, 32, 2, 2, moe_experts=4, device="cpu"), None,
        DecodeConfig(**CFG)), None, None),
    "http_port": (_http_server, None, None),
}


@pytest.mark.parametrize("what", sorted(_OUT_OF_SLICE))
def test_out_of_slice_options_raise(port_model, what):
    call, err, match = _OUT_OF_SLICE[what]
    if err is None:
        call(port_model)
        return
    with pytest.raises(err, match=match):
        call(port_model)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        place.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(VOCAB, 32, 2, 2, max_seq_len=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        weights_from_numpy({"layers": []})
    assert place.default_device("cpu") == torch.device("cpu")
    # the static-graph entry points of slice 2
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework.scope import scope_from_numpy

    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Executor(pt.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.framework.run_startup(pt.framework.Program())
    with pytest.raises(RuntimeError, match="CUDA"):
        scope_from_numpy({"w": np.zeros(2, "f4")})
    assert pt.Executor(pt.CPUPlace()).device == torch.device("cpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("target", ["paddle_tpu_torch", "chip_smoke.py"])
def test_port_imports_neither_jax_nor_the_jax_package(target):
    path = os.path.join(ROOT, target)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path)
        for f in fs if f.endswith(".py")]
    assert len(files) > (0 if path.endswith(".py") else 15)
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad


def _flag_reads(files):
    """Names passed as a string literal to ``flag(...)`` calls."""
    for f in files:
        for node in ast.walk(ast.parse(open(f).read(), filename=f)):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and getattr(node.func, "attr",
                                getattr(node.func, "id", None)) == "flag"):
                yield node.args[0].value


def test_every_defined_flag_is_read_by_the_port():
    from paddle_tpu_torch.framework import flags

    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py") and f != "flags.py"]
    defined = set(flags.flags_snapshot())
    assert defined == set(_flag_reads(files)) and len(defined) > 10


def test_flag_defaults_match_the_jax_package():
    from paddle_tpu.framework import flags as jflags
    from paddle_tpu_torch.framework import flags

    ours = flags.flags_snapshot()
    theirs = jflags.get_flags(sorted(ours))
    # the JAX package's MFU peak and the phase model's interconnect rate
    # default to a TPU's figures; the port's are 0 (MFU null, collectives
    # unpriced) until the caller sets the card's and the fabric's
    for tpu_figure in ("device_peak_tflops", "phase_interconnect_gbps"):
        assert ours.pop(tpu_figure) == 0.0
        theirs.pop(tpu_figure)
    assert ours == theirs
    with pytest.raises(KeyError, match="unknown flag"):
        flags.set_flags({"FLAGS_use_tpu": False})


def test_flight_metadata_and_record_event():
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.observe import flight, tracer

    meta = flight.run_metadata(include_devices=True)
    assert meta["torch_version"] == torch.__version__
    assert "jax_version" not in meta and "device_count" in meta
    flags.set_flags({"enable_tracer": True})
    try:
        tracer.clear()
        with profiler.RecordEvent("port/test_span"):
            time.sleep(0.001)
        names = [s.name for s in tracer.snapshot()]
    finally:
        flags.set_flags({"enable_tracer": False})
    assert "port/test_span" in names


def test_decode_request_traces_are_recorded(port_model):
    from paddle_tpu_torch.observe.request_trace import get_trace_store

    eng = DecodeEngine(port_model, None, DecodeConfig(**CFG))
    with eng:
        r = eng.submit([1, 2, 3], max_new_tokens=3)
        r.result(timeout=120)
    tr = get_trace_store().get(r.trace.trace_id)
    events = [e["name"] for e in tr.to_dict()["events"]]
    assert events[0] == "enqueue" and "admit" in events
    assert events.count("token") == 3 and tr.outcome == "completed"


def test_module_docstring_names_the_counterpart():
    assert "paddle_tpu/serving/decode.py" in tdec.__doc__
