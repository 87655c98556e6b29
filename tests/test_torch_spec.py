"""PyTorch port: speculative decoding (``DecodeEngine(draft_model=...)``).

The JAX package's weights (numpy, from PRNG keys) are carried into the
port with ``weights_from_numpy``; both engines serve the same requests on
the CPU.  The port's speculative contract: every emitted token is the
target's argmax in the verify logits, so greedy speculative output equals
non-speculative output wherever the logits' top-2 margin exceeds the
float tolerance between verification (B6's plain version at R = k + 1
rows) and the decode step (B5's at one row).  On these tiny random models
no margin comes that close, so the tokens are compared exactly: against
the port's own non-speculative run and the JAX engine's speculative run.
The acceptance counters are compared with the JAX engine's too, and
speculation over shared prefix pages (copy-on-write, which must copy the
draft's pools) must accept exactly what it accepts without sharing.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.monitor import stat_get as jstat_get
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.serving import decode as tdec
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      DecodeServer, TransformerLM,
                                      weights_from_numpy)

VOCAB, D_MODEL, LAYERS, HEADS = 128, 64, 2, 2     # head dim 32
SELF_TOL = 1e-5     # port streamed logits vs port recompute
CFG = dict(slots=2, max_seq_len=64, page_size=8, max_new_tokens=10)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1, 17, 40]]


def _jax_pair(d_model, layers, seed):
    import jax

    m = jdec.TransformerLM(VOCAB, d_model=d_model, num_layers=layers,
                           num_heads=HEADS, max_seq_len=64)
    w = m.init_weights(jax.random.PRNGKey(seed))
    return m, w, jax.tree_util.tree_map(np.asarray, w)


@pytest.fixture(scope="module")
def models():
    """The target, a weak 1-layer draft (different weights: low
    acceptance), the target's own layer 0 (partial acceptance) and the
    target itself (full acceptance), each in both packages."""
    out = {}
    for name, (dm, nl, seed) in {"target": (D_MODEL, LAYERS, 7),
                                 "low": (32, 1, 99)}.items():
        jm, jw, npw = _jax_pair(dm, nl, seed)
        tm = TransformerLM(VOCAB, d_model=dm, num_layers=nl,
                           num_heads=HEADS, max_seq_len=64, device="cpu")
        out[name] = dict(jm=jm, jw=jw, tm=tm,
                         tw=weights_from_numpy(npw, "cpu"))
    # the near draft: the target's layer 0 alone, sharing its embeddings,
    # final LayerNorm and head (partial acceptance)
    t = out["target"]
    jm = jdec.TransformerLM(VOCAB, d_model=D_MODEL, num_layers=1,
                            num_heads=HEADS, max_seq_len=64)
    jw = dict(t["jw"], layers=t["jw"]["layers"][:1])
    out["near"] = dict(jm=jm, jw=jw, tw=dict(t["tw"],
                                             layers=t["tw"]["layers"][:1]),
                       tm=TransformerLM(VOCAB, d_model=D_MODEL, num_layers=1,
                                        num_heads=HEADS, max_seq_len=64,
                                        device="cpu"))
    # the self-draft: a second port module holding the target's weights
    out["self"] = dict(jm=t["jm"], jw=t["jw"], tw=t["tw"],
                       tm=TransformerLM(VOCAB, d_model=D_MODEL,
                                        num_layers=LAYERS, num_heads=HEADS,
                                        max_seq_len=64, device="cpu"))
    return out


def _port(models, draft=None, **over):
    t = models["target"]
    d = models[draft] if draft else None
    return DecodeEngine(t["tm"], t["tw"], DecodeConfig(**dict(CFG, **over)),
                        draft_model=d["tm"] if d else None,
                        draft_weights=d["tw"] if d else None)


def _jax(models, draft=None, **over):
    t = models["target"]
    d = models[draft] if draft else None
    return jdec.DecodeEngine(t["jm"], t["jw"],
                             jdec.DecodeConfig(**dict(CFG, **over)),
                             draft_model=d["jm"] if d else None,
                             draft_weights=d["jw"] if d else None)


def _serve(engine, waves, get=stat_get, **kw):
    """Serve waves of prompts (each wave waited for before the next);
    returns the requests and the spec counters' deltas."""
    p0, a0, r0 = (get(n) for n in ("decode_spec_proposed",
                                   "decode_spec_accepted",
                                   "decode_spec_rounds"))
    engine.start()
    try:
        reqs = []
        for wave in waves:
            batch = [engine.submit(p, record_logits=True, **kw)
                     for p in wave]
            for r in batch:
                r.result(timeout=120)
            reqs += batch
    finally:
        engine.stop()
    return reqs, (get("decode_spec_proposed") - p0,
                  get("decode_spec_accepted") - a0,
                  get("decode_spec_rounds") - r0)


@pytest.mark.parametrize("draft", ["low", "self"])
@pytest.mark.parametrize("k", [1, 3])
def test_spec_tokens_equal_nonspec_and_jax(models, draft, k):
    base, _ = _serve(_port(models), [PROMPTS])
    eng = _port(models, draft, spec_k=k)
    spec, (proposed, _a, rounds) = _serve(eng, [PROMPTS])
    jspec, _ = _serve(_jax(models, draft, spec_k=k), [PROMPTS],
                      get=jstat_get)
    assert proposed > 0 and rounds > 0
    for b, s_, j in zip(base, spec, jspec):
        assert s_.generated == b.generated == j.generated
    eng._cache.debug_check()


@pytest.mark.parametrize("k", [1, 4])
def test_self_draft_full_acceptance_fewer_rounds(models, k):
    n_new = 12
    eng = _port(models, "self", spec_k=k, slots=1)
    (r,), (proposed, accepted, rounds) = _serve(
        eng, [[[1, 2, 3]]], max_new_tokens=n_new)
    assert len(r.generated) == n_new
    assert accepted == proposed > 0
    # prefill emits 1, each round k + 1, a possible final single step
    # the remainder
    assert rounds <= math.ceil((n_new - 1) / (k + 1))


@pytest.mark.parametrize("draft", ["low", "near"])
def test_spec_counters_equal_jax(models, draft):
    reqs, port = _serve(_port(models, draft, spec_k=3), [PROMPTS])
    jreqs, jax_ = _serve(_jax(models, draft, spec_k=3), [PROMPTS],
                         get=jstat_get)
    assert port == jax_ and port[0] > 0
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    if draft == "near":
        assert 0 < port[1] < port[0]    # partial acceptance


# wave 1 registers [7..1]; wave 2's prompt is wholly covered (its partial
# tail page borrowed, copied on write at the first generated token) and
# wave 2's second prompt hits the first full page then prefills a suffix
_SHARED = [[[7, 6, 5, 4, 3, 2, 1, 9, 10, 11]],
           [[7, 6, 5, 4, 3, 2, 1, 9, 10, 11], [7, 6, 5, 4, 3, 2, 1, 9, 33]]]


@pytest.mark.parametrize("draft", ["near", "self"])
def test_spec_composes_with_prefix_sharing(models, draft):
    """The same requests with and without prefix sharing give the same
    tokens; with sharing the port accepts exactly what the JAX engine
    accepts, and the self-draft still accepts everything (a full hit's
    first token comes from a speculative round, so the round counts of
    the two runs differ by design)."""
    plain, plain_counts = _serve(_port(models, draft, spec_k=2,
                                       prefix_cache=False), _SHARED)
    eng = _port(models, draft, spec_k=2)
    skip0, cow0 = stat_get("decode_prefill_skipped"), \
        stat_get("decode_cow_copies")
    shared, counts = _serve(eng, _SHARED)
    assert stat_get("decode_prefill_skipped") == skip0 + 1
    assert stat_get("decode_cow_copies") > cow0
    assert [r.generated for r in shared] == [r.generated for r in plain]
    _j, jax_counts = _serve(_jax(models, draft, spec_k=2), _SHARED,
                            get=jstat_get)
    # stale draft K/V (a CoW or a reset that skipped the draft pools)
    # would only show as lower acceptance
    assert counts == jax_counts
    if draft == "self":
        assert counts[1] == counts[0] and plain_counts[1] == plain_counts[0]
    eng._cache.debug_check()


def test_spec_vocab_mismatch_and_submit_rejections(models):
    t = models["target"]
    bad = TransformerLM(VOCAB + 1, 32, 1, 2, max_seq_len=64, device="cpu")
    with pytest.raises(ValueError, match="vocab mismatch"):
        DecodeEngine(t["tm"], None, DecodeConfig(**CFG), draft_model=bad,
                     draft_weights=bad.init_weights(
                         torch.Generator().manual_seed(0)))
    short = TransformerLM(VOCAB, 32, 1, 2, max_seq_len=32, device="cpu")
    with pytest.raises(ValueError, match="positional table"):
        DecodeEngine(t["tm"], None, DecodeConfig(**CFG), draft_model=short,
                     draft_weights=short.init_weights(
                         torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="needs draft_weights"):
        DecodeEngine(t["tm"], None, DecodeConfig(**CFG),
                     draft_model=models["low"]["tm"])
    with pytest.raises(ValueError, match="no draft"):
        _port(models).submit([1, 2], speculative=True)
    with pytest.raises(ValueError, match="spec_k"):
        _port(models, "low", spec_k=0).submit([1, 2], speculative=True)
    with pytest.raises(ValueError, match="greedy-only"):
        _port(models, "low", spec_k=2).submit([1, 2], speculative=True,
                                              temperature=0.7)


def test_spec_logits_match_recompute(models):
    eng = _port(models, "low", spec_k=3)
    reqs, _ = _serve(eng, [PROMPTS])
    for r in reqs:
        assert len(r.logits_trace) == len(r.generated) == 10
        for i, got in enumerate(r.logits_trace):
            want = eng.recompute_logits(r.prompt + r.generated[:i])
            np.testing.assert_allclose(got, want, rtol=0, atol=SELF_TOL)


def test_opt_out_sampled_and_kv_quant(models):
    """``speculative=False`` and sampled requests take the normal step on
    a speculative engine (their positions lag in the draft pools, so
    they never register); under kv_quant the draft's scale planes are
    reset and audited with the target's."""
    eng = _port(models, "self", spec_k=2, kv_quant=True)
    base, _ = _serve(_port(models, kv_quant=True), [PROMPTS])
    reqs, (proposed, accepted, _r) = _serve(eng, [PROMPTS])
    assert [r.generated for r in reqs] == [r.generated for r in base]
    assert accepted == proposed > 0
    assert set(eng._cache.scale_pools()) == {
        "k_scales", "v_scales", "draft_k_scales", "draft_v_scales"}
    eng._cache.debug_check()
    out, (proposed, _a, _r) = _serve(eng, [PROMPTS], speculative=False)
    sampled, _ = _serve(eng, [PROMPTS], temperature=1.0, seed=3)
    assert proposed == 0 and [r.generated for r in out] == \
        [r.generated for r in base]
    assert all(len(r.generated) == 10 for r in sampled)
    eng._cache.debug_check()


class _ReplayStandIn:
    """StepGraph stand-in on the CPU: the capture records the step, each
    replay reruns it from the (rewritten) input buffer."""

    def __init__(self, device):
        self.graph, self.outputs = None, None

    def on_side_stream(self, fn):
        return fn()

    def capture(self, fn, generators=()):
        self.graph, self._fn = True, fn

    def replay(self):
        self.outputs = self._fn()


def test_captured_steps_replay_the_same_tokens(models, monkeypatch):
    """The card's path on the CPU: the decode step, the proposal burst
    and the verification each run eager once, are captured, then replay
    fed only through their static input buffers."""
    monkeypatch.setattr(tdec, "StepGraph", _ReplayStandIn)
    base, base_counts = _serve(_port(models, "low", spec_k=3), [PROMPTS])
    eng = _port(models, "low", spec_k=3)
    eng._captures = True
    reqs, counts = _serve(eng, [PROMPTS, PROMPTS[:1]])
    assert sorted(eng._graphs) == ["decode", "propose", "verify"]
    assert all(g.graph for g in eng._graphs.values())
    assert [r.generated for r in reqs[:2]] == [r.generated for r in base]
    assert reqs[2].generated == base[0].generated
    assert counts[2] > base_counts[2]


def test_decode_server_with_draft(models):
    t, d = models["target"], models["self"]
    srv = DecodeServer(t["tm"], t["tw"], DecodeConfig(**dict(CFG, spec_k=2)),
                       replicas=2, draft_model=d["tm"],
                       draft_weights=d["tw"])
    with srv:
        outs = [srv.submit(p).result(timeout=120) for p in PROMPTS]
    base, _ = _serve(_port(models), [PROMPTS])
    assert outs == [r.generated for r in base]
    st = srv.stats()
    assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert st["spec_accept_rate"] == 1.0
