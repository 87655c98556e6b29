"""PyTorch port: the paged KV cache.

The host side (page tables, refcounts, free list, prefix trie, CoW,
eviction) is kept line for line from the JAX package, so a scripted
claim / release / prefix-hit / CoW / eviction sequence must give the
same page tables, refcounts and claim outcomes on both -- exactly.  The
device side (in-place writes, int8 quantization) is held against the
JAX functional writes byte for byte: quantization is elementwise with
round-half-to-even on both sides.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.framework.scope import Scope
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch.ops.quant_ops import SCALE_EPS
from paddle_tpu_torch.serving import kv_cache as tkv

L, H, D, SLOTS, MAX_SEQ, PAGE = 2, 2, 4, 3, 32, 4


def _caches(num_pages=None, quantized=False):
    jc = jkv.PagedKVCache(
        jkv.CacheConfig(L, H, D, SLOTS, MAX_SEQ, PAGE, num_pages=num_pages,
                        quantized=quantized), Scope())
    tc = tkv.PagedKVCache(
        tkv.CacheConfig(L, H, D, SLOTS, MAX_SEQ, PAGE, num_pages=num_pages,
                        quantized=quantized), "cpu")
    return jc, tc


def _same_books(jc, tc):
    np.testing.assert_array_equal(tc.page_table, jc.page_table)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    assert tc._refs == jc._refs
    assert tc.allocator._free == jc.allocator._free
    assert tc._slot_pages == jc._slot_pages
    assert tc._slot_refs == jc._slot_refs
    assert tc._cow_spare == jc._cow_spare
    assert sorted(tc.prefix._by_page) == sorted(jc.prefix._by_page)


def _info(i):
    return None if i is None else (i.hit_tokens, i.full_hits, i.partial,
                                   i.hit_pages, i.prompt_pages,
                                   i.fresh_pages)


def test_scripted_bookkeeping_matches_jax():
    jc, tc = _caches()
    a = list(range(1, 11))            # 10 tokens: 2 full pages + 2
    b = a[:8] + [50, 51, 52]          # shares a's two full pages
    c = list(a)                       # whole prompt covered (partial hit)
    steps = []
    for cache in (jc, tc):
        log = []
        log.append(_info(cache.claim(0, 14, prompt=a)))
        cache.lengths[0] = 12
        cache.release(0, register_tokens=a + [90, 91])
        log.append(_info(cache.claim(1, 15, prompt=b)))
        log.append(_info(cache.claim(2, 13, prompt=c)))
        cache.lengths[2] = 9
        # c's first generated token lands in the borrowed partial page
        log.append(cache.plan_cow(2, [10]))
        log.append(cache.write_coords(2))
        cache.release(1)
        cache.release(2, register_tokens=c + [7, 7])
        cache.debug_check()
        steps.append(log)
        if cache is jc:
            jlog = log
    assert steps[0] == steps[1]
    assert jlog[1][1] == 2 and jlog[2][2] is True  # the paths were taken
    assert len(jlog[3]) == 1                        # one CoW copy
    _same_books(jc, tc)


def test_eviction_under_pressure_matches_jax():
    # 7 allocatable pages: registered prefixes must be evicted LRU
    jc, tc = _caches(num_pages=8)
    outs = []
    for cache in (jc, tc):
        log = []
        for i, start in enumerate((100, 200, 300)):
            p = list(range(start, start + 8))
            log.append(_info(cache.claim(i % SLOTS, 12, prompt=p)))
            cache.lengths[i % SLOTS] = 8
            cache.release(i % SLOTS, register_tokens=p)
            log.append(cache.shared_pages)
        log.append(_info(cache.claim(0, 28, prompt=list(range(7)))))
        log.append(cache.allocator.num_free)
        cache.debug_check()
        outs.append(log)
    assert outs[0] == outs[1]
    _same_books(jc, tc)


def test_claim_blocks_when_pool_short_like_jax():
    jc, tc = _caches(num_pages=6)
    for cache in (jc, tc):
        assert cache.claim(0, 16, prompt=[1, 2, 3]) is not None
        assert cache.claim(1, 8, prompt=[4]) is None   # 1 page left
        assert cache.allocator.num_free == 1
    _same_books(jc, tc)


@pytest.mark.parametrize("dtype,quant", [("float32", False),
                                         ("bfloat16", False),
                                         ("float32", True)])
def test_cache_config_bytes_match_jax(dtype, quant):
    j = jkv.CacheConfig(4, 8, 64, 8, 1024, 16, dtype=dtype, quantized=quant)
    t = tkv.CacheConfig(4, 8, 64, 8, 1024, 16, dtype=dtype, quantized=quant)
    assert t.page_bytes() == j.page_bytes()
    assert t.cache_bytes() == j.cache_bytes()
    assert t.num_pages == j.num_pages == 8 * 64 + 1


def test_quantize_kv_bytes_equal_jax():
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    val = rs.randn(5, 3, H, 16).astype("f4") * 3.0
    val[0, 0, 0] = 0.0                       # all-zero head: eps scale
    # exact .5 ties in val / scale: max |x| = 127 so scale == 1.0
    val[1, 0, 1] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 4.5]
                            + [0.0] * 8, "f4")
    jq, js = jkv.quantize_kv(jnp.asarray(val))
    tq, ts = tkv.quantize_kv(torch.from_numpy(val))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 0, 0]) == np.float32(SCALE_EPS)


def test_round_is_half_to_even_like_jnp():
    """quantize_kv's byte parity rests on torch.round and jnp.round
    both rounding half to even."""
    import jax.numpy as jnp

    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], "f4")
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(x)))
    assert torch.round(torch.tensor(2.5)).item() == 2.0
    q, _ = tkv.quantize_kv(torch.tensor([[127.0, 0.5, 1.5, 2.5]]))
    assert q.tolist() == [[127, 0, 2, 2]]


def test_dequantize_kv_matches_jax():
    import jax.numpy as jnp

    rs = np.random.RandomState(1)
    q = rs.randint(-127, 128, (4, H, D)).astype("i1")
    s = rs.uniform(0.01, 0.1, (4, H)).astype("f4")
    want = np.asarray(jkv.dequantize_kv(jnp.asarray(q), jnp.asarray(s),
                                        jnp.float32))
    got = tkv.dequantize_kv(torch.from_numpy(q), torch.from_numpy(s),
                            "float32")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_in_place_writes_match_jax(quant):
    """write_token_layer / write_prompt_layer update the torch pools in
    place and store the same bytes as the JAX functional writes."""
    import jax.numpy as jnp

    rs = np.random.RandomState(2)
    jc, tc = _caches(quantized=quant)
    tp = tc.target
    jk = jc.scope.get_var(jkv.K_PAGES_VAR)
    js = jc.scope.get_var(jkv.K_SCALES_VAR) if quant else None
    tok = rs.randn(3, H, D).astype("f4")
    page_id = np.array([5, 0, 0], "i4")      # two dead rows to trash
    off = np.array([2, 0, 0], "i4")
    tok[2] = tok[1]  # duplicate trash writes carry identical values
    jk, js = jkv.write_token_layer(jk, js, 1, jnp.asarray(tok),
                                   jnp.asarray(page_id), jnp.asarray(off))
    ptr = tp.k_pages.data_ptr()
    tkv.write_token_layer(tp.k_pages, tp.k_scales, 1, torch.from_numpy(tok),
                          torch.from_numpy(page_id), torch.from_numpy(off))
    prompt = rs.randn(2 * PAGE, H, D).astype("f4")
    pages = np.array([7, 3], "i4")
    jk, js = jkv.write_prompt_layer(jk, js, 0, jnp.asarray(prompt),
                                    jnp.asarray(pages))
    tkv.write_prompt_layer(tp.k_pages, tp.k_scales, 0,
                           torch.from_numpy(prompt), torch.from_numpy(pages))
    assert tp.k_pages.data_ptr() == ptr      # updated in place
    np.testing.assert_array_equal(tp.k_pages.numpy(), np.asarray(jk))
    if quant:
        np.testing.assert_array_equal(tp.k_scales.numpy(), np.asarray(js))


def test_copy_page_and_freed_scale_reset():
    _, tc = _caches(quantized=True)
    tp = tc.target
    info = tc.claim(0, 8, prompt=[1, 2, 3, 4, 5])
    assert info.fresh_pages == 2
    src, dst = tc.slot_pages(0)
    val = torch.randn(2, H, D)
    tkv.write_token_layer(tp.k_pages, tp.k_scales, 1, val,
                          torch.tensor([src, src]), torch.tensor([0, 1]))
    tc.copy_page(src, dst)
    for pool in tc.pools():
        assert torch.equal(pool[:, dst], pool[:, src])
    tc.release(0)
    # both freed pages: scale planes back to SCALE_EPS, audit passes
    assert torch.all(tp.k_scales[:, [src, dst]] == SCALE_EPS)
    tc.debug_check()
    tp.k_scales[0, src, 0, 0] = 2.0          # a stale live scale
    with pytest.raises(AssertionError, match="freed pages"):
        tc.debug_check()


def test_cache_dtype_names():
    assert tkv.torch_dtype("bfloat16") is torch.bfloat16
    assert tkv.torch_dtype(np.dtype("float32")) is torch.float32
    with pytest.raises(ValueError, match="unsupported cache dtype"):
        tkv.torch_dtype("int4")
