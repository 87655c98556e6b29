"""PyTorch port: ragged prefill packing
(``DecodeConfig(ragged_prefill_rows=L)`` with chunked prefill).

Each dispatch packs L one-row lanes of several prompts' chunk tails into
one fixed-width ``_rows_forward`` (S = L lanes, R = 1, each lane its own
copy of its slot's page-table row), so the dead rows of padding each
prompt's chunk are shared.  On the CPU (B6's plain version): greedy
tokens equal the padded chunk path's and the JAX engine's ragged path's,
logits agree with the padded path's within 1e-5, the pad waste drops,
and the lane deal -- which (slot, start, lanes) each dispatch packs --
equals the JAX engine's, read off both engines' request timelines.
"""
import numpy as np
import pytest

from paddle_tpu.monitor import stat_get as jstat_get
from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      TransformerLM, weights_from_numpy)

VOCAB = 128
SELF_TOL = 1e-5
CFG = dict(slots=4, max_seq_len=64, page_size=8, prefill_chunk_pages=1,
           prefix_cache=False)
PROMPTS = [list(range(1, 28)), [7, 3, 9, 2, 11, 5, 4, 8, 6, 1, 2, 3, 4],
           [5, 1, 2, 4, 3]]


@pytest.fixture(scope="module")
def models():
    import jax

    jm = jdec.TransformerLM(VOCAB, d_model=64, num_layers=2, num_heads=2,
                            max_seq_len=64)
    jw = jm.init_weights(jax.random.PRNGKey(7))
    tm = TransformerLM(VOCAB, d_model=64, num_layers=2, num_heads=2,
                       max_seq_len=64, device="cpu")
    tm.load_weights(weights_from_numpy(
        jax.tree_util.tree_map(np.asarray, jw), "cpu"))
    return jm, jw, tm


def _run(engine, prompts, get=stat_get, **kw):
    """Queue every prompt before the engine starts (so the first loop
    iteration admits them together and the deal is deterministic); the
    requests and the pad-waste fraction of their prefill dispatches."""
    p0 = get("prefill_padded_tokens_total")
    l0 = get("prefill_live_tokens_total")
    reqs = [engine.submit(p, max_new_tokens=5, record_logits=True, **kw)
            for p in prompts]
    engine.start()
    try:
        for r in reqs:
            r.result(timeout=120)
    finally:
        engine.stop()
    pad = get("prefill_padded_tokens_total") - p0
    live = get("prefill_live_tokens_total") - l0
    return reqs, pad / (pad + live)


def _deal(reqs):
    """Each request's ragged prefill chunks, (start, rows) in order."""
    out = []
    for r in reqs:
        ev = r.trace.to_dict()["events"]
        out.append([(e["start"], e["rows"]) for e in ev
                    if e["name"] == "prefill_chunk" and e.get("ragged")])
    return out


def test_ragged_tokens_equal_padded_and_jax(models):
    jm, jw, tm = models
    padded, _ = _run(DecodeEngine(tm, None, DecodeConfig(**CFG)), PROMPTS)
    r0 = stat_get("decode_ragged_dispatches")
    ragged, _ = _run(DecodeEngine(tm, None, DecodeConfig(
        **CFG, ragged_prefill_rows=16)), PROMPTS)
    jragged, _ = _run(jdec.DecodeEngine(jm, jw, jdec.DecodeConfig(
        **CFG, ragged_prefill_rows=16)), PROMPTS, get=jstat_get)
    assert stat_get("decode_ragged_dispatches") - r0 >= 2
    for p, r, j in zip(padded, ragged, jragged):
        assert r.generated == p.generated == j.generated
        for a, b in zip(r.logits_trace, p.logits_trace):
            np.testing.assert_allclose(a, b, rtol=0, atol=SELF_TOL)


def test_pad_waste_drops(models):
    _jm, _jw, tm = models
    _p, padded = _run(DecodeEngine(tm, None, DecodeConfig(**CFG)), PROMPTS)
    _r, ragged = _run(DecodeEngine(tm, None, DecodeConfig(
        **CFG, ragged_prefill_rows=16)), PROMPTS)
    # padding rounds 27/13/5 up to 8-row chunks (56 rows for 45 live);
    # packing shares 3 x 16 lanes (48 rows)
    assert 0 <= ragged < padded
    eng = DecodeEngine(tm, None, DecodeConfig(**CFG, ragged_prefill_rows=16))
    assert eng.stats()["ragged_prefill_rows"] == 16


def test_single_prompt_matches_recompute(models):
    _jm, _jw, tm = models
    eng = DecodeEngine(tm, None, DecodeConfig(
        **dict(CFG, slots=2), ragged_prefill_rows=16))
    (r,), _ = _run(eng, [list(range(1, 28))])
    assert len(r.generated) == 5
    for i, got in enumerate(r.logits_trace):
        want = eng.recompute_logits(r.prompt + r.generated[:i])
        np.testing.assert_allclose(got, want, rtol=0, atol=SELF_TOL)
    eng._cache.debug_check()


@pytest.mark.parametrize("lanes", [16, 24])
def test_lane_deal_equals_jax(models, lanes):
    jm, jw, tm = models
    prompts = PROMPTS + [[9] * 40]
    ragged, _ = _run(DecodeEngine(tm, None, DecodeConfig(
        **CFG, ragged_prefill_rows=lanes)), prompts)
    jragged, _ = _run(jdec.DecodeEngine(jm, jw, jdec.DecodeConfig(
        **CFG, ragged_prefill_rows=lanes)), prompts, get=jstat_get)
    deal = _deal(ragged)
    assert deal == _deal(jragged)
    # every prompt position is dealt exactly once, in order
    for p, chunks in zip(prompts, deal):
        assert chunks[0][0] == 0 and sum(t for _s, t in chunks) == len(p)
        assert all(a[0] + a[1] == b[0] for a, b in zip(chunks, chunks[1:]))


def test_ragged_mirrors_into_draft_pools(models):
    """A speculative engine's ragged lanes also fill the draft's pools:
    the self-draft then accepts every proposal."""
    _jm, _jw, tm = models
    draft = TransformerLM(VOCAB, d_model=64, num_layers=2, num_heads=2,
                          max_seq_len=64, device="cpu")
    w = {k: v for k, v in tm.state_dict().items()}
    dw = {k: w[k] for k in ("tok_emb", "pos_emb", "lm_head", "lnf_g",
                            "lnf_b")}
    dw["layers"] = [{n: w[f"layers.{i}.{n}"] for n in
                     ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo", "ln2_g",
                      "ln2_b", "w1", "w2")} for i in range(2)]
    padded, _ = _run(DecodeEngine(tm, None, DecodeConfig(**CFG)), PROMPTS)
    p0 = stat_get("decode_spec_proposed")
    a0 = stat_get("decode_spec_accepted")
    eng = DecodeEngine(tm, None, DecodeConfig(
        **CFG, ragged_prefill_rows=16, spec_k=2), draft_model=draft,
        draft_weights=dw)
    spec, _ = _run(eng, PROMPTS)
    assert [r.generated for r in spec] == [r.generated for r in padded]
    proposed = stat_get("decode_spec_proposed") - p0
    assert proposed > 0 and stat_get("decode_spec_accepted") - a0 == proposed
    eng._cache.debug_check()


def test_packed_dispatch_fault_fails_every_packed_request(models):
    """The first dispatch packs 8 lanes of each of the first two prompts
    (a chunk's share each, 16 lanes); a fault there fails both, and the
    third prompt, dealt into the next dispatch, completes."""
    _jm, _jw, tm = models
    eng = DecodeEngine(tm, None, DecodeConfig(**CFG, ragged_prefill_rows=16))
    calls = []
    rows_forward = eng._rows_forward

    def boom(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected ragged fault")
        return rows_forward(*a, **kw)
    eng._rows_forward = boom
    reqs = [eng.submit(p, max_new_tokens=3) for p in PROMPTS]
    eng.start()
    try:
        for r in reqs[:2]:
            with pytest.raises(RuntimeError, match="injected ragged fault"):
                r.result(timeout=120)
        assert len(reqs[2].result(timeout=120)) == 3
        # the engine keeps serving after the shared dispatch failed
        assert len(eng.generate(PROMPTS[2], max_new_tokens=3)) == 3
    finally:
        eng.stop()
    eng._cache.debug_check()
