"""PyTorch port: the paged attention ops (B5 decode, B6 chunk).

The port's plain PyTorch versions -- what its wrappers run on CPU
tensors -- are held against the JAX package's ``paged_decode_attention``
and ``paged_chunk_attention``, both through the Pallas kernel in
interpret mode (``use_pallas="always"``) and through the jnp reference
(``"never"``), on the same numpy inputs: float32 and int8 pools, partial
tail pages, shuffled page tables.  Tolerance 1e-5 absolute: float32 on
both sides, the two differ only in summation order.  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` holds them against
these plain versions); here the wrappers' argument checks are exercised
with ``meta`` tensors, which need no GPU.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_decode_attention as jpa
from paddle_tpu_torch.ops import paged_attention as pa

TOL = 1e-5  # float32 both sides: summation order only
S, H, D, PAGE, PPS = 4, 2, 16, 8, 4
N_PAGES = S * PPS + 1


def _inputs(seed, rows=None, quant=False):
    rs = np.random.RandomState(seed)
    qshape = (S, H, D) if rows is None else (S, rows, H, D)
    q = rs.randn(*qshape).astype("f4")
    if quant:
        kp = rs.randint(-127, 128, (N_PAGES, PAGE, H, D)).astype("i1")
        vp = rs.randint(-127, 128, (N_PAGES, PAGE, H, D)).astype("i1")
        ks = rs.uniform(0.001, 0.02, (N_PAGES, PAGE, H)).astype("f4")
        vs = rs.uniform(0.001, 0.02, (N_PAGES, PAGE, H)).astype("f4")
    else:
        kp = rs.randn(N_PAGES, PAGE, H, D).astype("f4")
        vp = rs.randn(N_PAGES, PAGE, H, D).astype("f4")
        ks = vs = None
    # shuffled, disjoint page ids per slot (page 0, the trash page, unused)
    table = (rs.permutation(N_PAGES - 1) + 1).reshape(S, PPS).astype("i4")
    return q, kp, vp, ks, vs, table


def _jax(fn, mode, *arrays, **kw):
    import jax.numpy as jnp

    conv = [None if a is None else jnp.asarray(a) for a in arrays]
    q, kp, vp, table, lens, ks, vs = conv
    out = fn(q, kp, vp, table, lens, use_pallas=mode,
             interpret=mode == "always", k_scales=ks, v_scales=vs, **kw)
    return np.asarray(out)


def _torch(fn, *arrays):
    q, kp, vp, table, lens, ks, vs = [
        None if a is None else torch.from_numpy(np.array(a))
        for a in arrays]
    return fn(q, kp, vp, table, lens, k_scales=ks, v_scales=vs).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("mode", ["always", "never"],
                         ids=["pallas_interpret", "jnp_reference"])
def test_decode_plain_matches_jax(mode, quant):
    q, kp, vp, ks, vs, table = _inputs(0, quant=quant)
    # page boundary, partial tail page, the whole table, one token
    lens = np.array([8, 17, 32, 1], "i4")
    want = _jax(jpa.paged_decode_attention, mode, q, kp, vp, table, lens,
                ks, vs)
    got = _torch(pa.paged_decode_attention, q, kp, vp, table, lens, ks, vs)
    assert got.shape == (S, H, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("mode", ["always", "never"],
                         ids=["pallas_interpret", "jnp_reference"])
def test_chunk_plain_matches_jax(mode, quant):
    q, kp, vp, ks, vs, table = _inputs(1, rows=3, quant=quant)
    # causal rows of a chunk (ascending) plus one slot with rows out of
    # order -- the page skip must follow the widest row
    lens = np.array([[6, 7, 8], [15, 16, 17], [30, 31, 32], [9, 2, 5]], "i4")
    want = _jax(jpa.paged_chunk_attention, mode, q, kp, vp, table, lens,
                ks, vs)
    got = _torch(pa.paged_chunk_attention, q, kp, vp, table, lens, ks, vs)
    assert got.shape == (S, 3, H, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_decode_is_chunk_at_one_row():
    q, kp, vp, ks, vs, table = _inputs(2)
    lens = np.array([3, 9, 24, 16], "i4")
    dec = _torch(pa.paged_decode_attention, q, kp, vp, table, lens, ks, vs)
    chk = _torch(pa.paged_chunk_attention, q[:, None], kp, vp, table,
                 lens[:, None], ks, vs)[:, 0]
    np.testing.assert_array_equal(dec, chk)


def test_zero_length_row_returns_zero():
    """The TPU kernels' l == 0 guard: a row with no live position is 0
    (the JAX jnp reference would return the mean of V instead, so no
    parity test feeds it such a row; the engine never asks for one)."""
    q, kp, vp, ks, vs, table = _inputs(3)
    lens = np.array([0, 5, 0, 12], "i4")
    got = _torch(pa.paged_decode_attention, q, kp, vp, table, lens, ks, vs)
    assert np.all(got[[0, 2]] == 0.0)
    assert np.all(np.abs(got[[1, 3]]).sum(axis=(1, 2)) > 0)


def test_lengths_clamp_to_table_width():
    q, kp, vp, ks, vs, table = _inputs(4, rows=2)
    q[:, 1] = q[:, 0]
    full = PPS * PAGE
    lens = np.array([[full, full + 5]] * S, "i4")
    got = _torch(pa.paged_chunk_attention, q, kp, vp, table, lens, ks, vs)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


def test_bfloat16_pool_output_in_q_dtype():
    q, kp, vp, ks, vs, table = _inputs(5)
    lens = torch.tensor([4, 9, 20, 32], dtype=torch.int32)
    qt = torch.from_numpy(q)
    kb = torch.from_numpy(kp).to(torch.bfloat16)
    vb = torch.from_numpy(vp).to(torch.bfloat16)
    tt = torch.from_numpy(table)
    out32 = pa.paged_decode_attention(qt, kb, vb, tt, lens)
    out16 = pa.paged_decode_attention(qt.to(torch.bfloat16), kb, vb, tt,
                                      lens)
    assert out32.dtype == torch.float32 and out16.dtype == torch.bfloat16
    # same bf16 K/V, q rounded to bf16 and the output rounded to bf16:
    # a few bf16 ulps of outputs of magnitude ~1
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               rtol=0, atol=5e-2)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, kp, vp, ks, vs, table = _inputs(6)
    lens = np.array([1, 2, 3, 4], "i4")
    pa.reset_launch_counts()
    got = _torch(pa.paged_decode_attention, q, kp, vp, table, lens, ks, vs)
    ref = _torch(pa.paged_decode_attention_reference, q, kp, vp, table,
                 lens, ks, vs)
    np.testing.assert_array_equal(got, ref)
    assert pa.paged_decode_attention.launches == 0
    assert pa.paged_chunk_attention.launches == 0


def _meta_args(rows=None, **over):
    """Valid kernel arguments as meta tensors (shapes and dtypes only);
    ``over`` replaces some of them."""
    qshape = (S, H, 64) if rows is None else (S, rows, H, 64)
    lshape = (S,) if rows is None else (S, rows)
    m = dict(device="meta")
    args = dict(
        q=torch.empty(qshape, **m),
        k_pages=torch.empty(N_PAGES, PAGE, H, 64, **m),
        v_pages=torch.empty(N_PAGES, PAGE, H, 64, **m),
        page_table=torch.empty(S, PPS, dtype=torch.int32, **m),
        lengths=torch.empty(lshape, dtype=torch.int32, **m),
        k_scales=None, v_scales=None)
    args.update(over)
    return args


def _call(fn, a):
    return fn(a["q"], a["k_pages"], a["v_pages"], a["page_table"],
              a["lengths"], k_scales=a["k_scales"], v_scales=a["v_scales"])


_BAD = {
    "mixed_devices": dict(q=torch.zeros(S, H, 64)),
    "q_dtype": dict(q=torch.empty(S, H, 64, dtype=torch.float16,
                                  device="meta")),
    "pool_dtype_mismatch": dict(v_pages=torch.empty(
        N_PAGES, PAGE, H, 64, dtype=torch.bfloat16, device="meta")),
    "head_dim_unsupported": dict(
        q=torch.empty(S, H, 16, device="meta"),
        k_pages=torch.empty(N_PAGES, PAGE, H, 16, device="meta"),
        v_pages=torch.empty(N_PAGES, PAGE, H, 16, device="meta")),
    "q_heads_mismatch": dict(q=torch.empty(S, H + 1, 64, device="meta")),
    "int8_without_scales": dict(
        k_pages=torch.empty(N_PAGES, PAGE, H, 64, dtype=torch.int8,
                            device="meta"),
        v_pages=torch.empty(N_PAGES, PAGE, H, 64, dtype=torch.int8,
                            device="meta")),
    "table_int64": dict(page_table=torch.empty(S, PPS, dtype=torch.int64,
                                               device="meta")),
    "lengths_shape": dict(lengths=torch.empty(S + 1, dtype=torch.int32,
                                              device="meta")),
    "not_contiguous": dict(k_pages=torch.empty(
        N_PAGES, PAGE, 64, H, device="meta").transpose(2, 3)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_kernel_wrapper_rejects_bad_arguments(case):
    a = _meta_args(**_BAD[case])
    with pytest.raises(ValueError):
        _call(pa.paged_decode_attention, a)


def test_kernel_wrappers_refuse_non_cuda_devices():
    """Valid arguments on a device that is neither the CPU nor CUDA:
    the wrapper raises instead of falling back to the plain version."""
    before = pa.paged_decode_attention.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        _call(pa.paged_decode_attention, _meta_args())
    with pytest.raises(RuntimeError, match="CUDA"):
        _call(pa.paged_chunk_attention, _meta_args(rows=4))
    assert pa.paged_decode_attention.launches == before


def test_chunk_wrapper_takes_large_pages():
    """The chunk kernel stages positions, not pages, so a page of 64
    positions at head_dim 128 passes every check before the device's."""
    a = _meta_args(
        rows=2,
        k_pages=torch.empty(N_PAGES, 64, H, 128, device="meta"),
        v_pages=torch.empty(N_PAGES, 64, H, 128, device="meta"),
        q=torch.empty(S, 2, H, 128, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        _call(pa.paged_chunk_attention, a)
