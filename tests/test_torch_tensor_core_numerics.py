"""PyTorch port: the arithmetic of the tensor-core kernels, emulated on the
CPU.

B1's bfloat16 kernel (``csrc/flash_attention.cu``, ``flash_fwd_mma_kernel``)
and B7 (``csrc/dequant_matmul.cu``) run their products on Hopper's tensor
cores in bfloat16 with float32 accumulation, yet are held to float32
tolerances on the card.  These tests redo, in torch on the CPU, the steps
that make that possible, with inputs made from a seed with numpy, and hold
the result to the tolerances ``chip_smoke.py`` holds the kernels to:

- every int8 code and every finite float8 e4m3 value is exact in bfloat16,
  so B7's carrier widens exactly;
- float32 x splits into three bfloat16 pieces within 2**-24 of itself (P
  into two within 2**-16); +-inf and NaN are their own head piece with
  nothing after it, so B7 gives the plain version's IEEE results for them;
  a finite x beyond bfloat16's range is taken as +-inf (by design);
- B7: three bfloat16-piece products over K steps of 64, each step's
  products summed apart and added to a float32 sum, K split as
  ``plan_split_k`` plans it, the scale applied after the K sum: within
  ``DEQUANT_TOL * sum_k |x w|`` of ``dequant_matmul_reference`` (and of the
  JAX package's kernel in interpret mode);
- B1: q k^T from bfloat16 inputs, an online softmax over 64-key blocks
  with the running max starting at -1e30, O += P_lo V + P_hi V, the output
  rounded to bfloat16 once: within ``TOL + REL_TOL * |plain|`` (3e-5 +
  2**-7 |plain|) of ``flash_attention_bias_reference`` and of the JAX
  package's kernel in interpret mode; a row whose bias is -inf everywhere
  gives 0;
- the split-K planner covers K exactly and fills the card on the small-M
  shapes of the served BERT.

A float32 sum over a step stands in for the tensor cores' accumulation,
which this emulation cannot reproduce bit for bit.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops import quant_ops as jq
from paddle_tpu.ops.pallas_attention import flash_attention_bias as jflash
from paddle_tpu_torch.ops import flash_attention_bias as fab
from paddle_tpu_torch.ops import quant_ops as tq

DEQUANT_TOL = 2.0 ** -20          # chip_smoke.py's B7 tolerance
TOL, REL_TOL = 3e-5, 2.0 ** -7    # chip_smoke.py's bfloat16 B1 tolerance
NEG_INF = -1e30


def _bf16(t):
    """Round float32 to bfloat16 (nearest even) and back."""
    return t.to(torch.bfloat16).float()


def _split(x, pieces):
    """The kernels' split (``csrc/mma_common.cuh``): each piece the
    bfloat16 rounding of what the ones before leave, and 0 after a piece
    that is not finite (+-inf, NaN, or the inf a finite value beyond
    bfloat16's range rounds to)."""
    out, rest = [], x
    for _ in range(pieces):
        p = _bf16(rest)
        out.append(p)
        rest = rest - p
        rest = torch.where(torch.isfinite(rest), rest, torch.zeros_like(rest))
    return out


# -- B7 -------------------------------------------------------------------


def test_every_int8_code_is_exact_in_bfloat16():
    codes = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    assert torch.equal(_bf16(codes.float()), codes.float())


def test_every_finite_e4m3_value_is_exact_in_bfloat16():
    e4m3 = torch.arange(256, dtype=torch.int16).to(torch.uint8) \
        .view(torch.float8_e4m3fn).float()
    finite = e4m3[torch.isfinite(e4m3)]
    assert finite.numel() == 254     # 0x7f and 0xff are NaN
    assert torch.equal(_bf16(finite), finite)


@pytest.mark.parametrize("pieces,bound", [(3, 2.0 ** -24), (2, 2.0 ** -16)])
def test_bfloat16_split_reconstructs_float32(pieces, bound):
    rs = np.random.RandomState(0)
    x = (rs.randn(1 << 16) * np.exp2(rs.randint(-30, 30, 1 << 16))) \
        .astype("f4")
    parts = _split(torch.from_numpy(x), pieces)
    assert all(torch.equal(_bf16(p), p) for p in parts)
    back = sum(p.double() for p in parts)
    err = (back - torch.from_numpy(x).double()).abs()
    assert float((err - bound * torch.from_numpy(np.abs(x))).max()) <= 0


@pytest.mark.parametrize("value", [float("inf"), float("-inf")],
                         ids=["inf", "minus_inf"])
def test_infinite_x_gives_the_ieee_result(value):
    """+-inf splits into itself and zeros, so B7 gives +-inf, and NaN where
    it meets a zero code, as the plain version and the JAX package do."""
    x = torch.tensor([[value, 1.0], [value, 2.0]])
    hi, mid, lo = _split(x, 3)
    assert bool((hi[:, 0] == value).all())
    assert bool((mid[:, 0] == 0).all()) and bool((lo[:, 0] == 0).all())
    q = torch.tensor([[1, -1, 0], [1, 1, 1]], dtype=torch.int8)
    scale = torch.tensor([0.5, 0.25, 1.0])
    got = _emulate_b7(x, q, scale)
    want = tq.dequant_matmul_reference(x, q, scale)
    assert bool(want[:, :2].isinf().all()) and bool(want[:, 2].isnan().all())
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[:, :2], want[:, :2])


def test_x_beyond_bfloat16_range_is_taken_as_inf():
    """By design (a guard of two instructions a value): a finite x whose
    bfloat16 rounding overflows (|x| >= 3.3962e38, the top 0.2 % of
    float32's range) is taken as +-inf by B7's split, where the plain
    version's product stays finite for |w| < 1."""
    x = torch.tensor([[3.4e38, 1.0], [-3.4e38, 1.0]])
    assert bool(_bf16(x[:, 0]).isinf().all())
    q = torch.ones(2, 1, dtype=torch.int8)
    scale = torch.tensor([0.5])
    got = _emulate_b7(x, q, scale)
    want = tq.dequant_matmul_reference(x, q, scale)
    assert bool(torch.isfinite(want).all())
    assert got[0, 0] == float("inf") and got[1, 0] == float("-inf")


def _emulate_b7(x, q, scale, k_step=64):
    """B7's arithmetic for float32 x: per K split, per K step of 64, the
    lo, mid and hi products summed apart, then added to a float32 sum;
    the splits summed in order; the scale applied last."""
    m, k = x.shape
    n = q.shape[1]
    splits, chunk = tq.plan_split_k(m, k, n, 4)
    w = q.float()            # exact in bfloat16 (the tests above)
    pieces = _split(x, 3)[::-1]   # small pieces first
    total = torch.zeros(m, n)
    for z in range(splits):
        acc = torch.zeros(m, n)
        for k0 in range(z * chunk, min(k, (z + 1) * chunk), k_step):
            k1 = min(k, (z + 1) * chunk, k0 + k_step)
            step = torch.zeros(m, n)
            for p in pieces:
                step = step + p[:, k0:k1] @ w[k0:k1]
            acc = acc + step
        total = total + acc
    return total * scale[None, :]


def _dequant_case(seed, m, k, n, mode, zero_col=None):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(m, k).astype("f4"))
    w = rs.randn(k, n).astype("f4")
    w[:, 0] *= 30.0           # an outlier channel, as chip_smoke.py's
    if zero_col is not None:
        w[:, zero_col] = 0.0
    q, scale = tq.quantize_weight(torch.from_numpy(w), 1, mode)
    return x, q, scale


def _assert_within_dequant_tol(got, want, x, q, scale):
    size = x.double().abs() @ tq.dequantize_weight(q, scale, 1).double().abs()
    excess = (got.double() - want.double()).abs() - DEQUANT_TOL * size
    assert float(excess.max()) <= 0, float(excess.max())


@pytest.mark.parametrize("m,k,n,mode", [
    (64, 768, 96, "int8"), (64, 768, 96, "fp8_e4m3"),
    (64, 3072, 96, "int8"), (64, 3072, 96, "fp8_e4m3"),
    (100, 300, 70, "int8"),     # ragged, split K
    (32, 768, 2, "fp8_e4m3"),   # the NSP head, split K
])
def test_split_product_meets_the_dequant_tolerance(m, k, n, mode):
    x, q, scale = _dequant_case(1, m, k, n, mode)
    got = _emulate_b7(x, q, scale)
    want = tq.dequant_matmul_reference(x, q, scale)
    _assert_within_dequant_tol(got, want, x, q, scale)


def test_split_product_meets_the_jax_kernel():
    """256 x 512 x 256, a shape the JAX kernel's tiles divide (interpret
    mode)."""
    x, q, scale = _dequant_case(2, 256, 512, 256, "int8")
    theirs = np.array(jq.dequant_matmul(
        jnp.asarray(x.numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(scale.numpy()), use_pallas="always", interpret=True))
    _assert_within_dequant_tol(_emulate_b7(x, q, scale),
                               torch.from_numpy(theirs), x, q, scale)


def test_zero_channel_stays_exact():
    for mode in ("int8", "fp8_e4m3"):
        x, q, scale = _dequant_case(3, 64, 96, 40, mode, zero_col=7)
        assert float(scale[7]) == np.float32(tq.SCALE_EPS)
        assert bool((_emulate_b7(x, q, scale)[:, 7] == 0).all())


def test_split_k_plan_covers_k_and_fills_the_card():
    blocks = tq.SPLIT_K_BLOCKS
    for m, k, n in [(128, 768, 3072), (128, 3072, 768), (32, 768, 768),
                    (32, 768, 2), (100, 300, 70), (4096, 768, 3072),
                    (4096, 3072, 768), (4096, 768, 768), (7, 5, 3)]:
        for size in (4, 2):
            splits, chunk = tq.plan_split_k(m, k, n, size)
            assert splits * chunk >= k > (splits - 1) * chunk
            if splits > 1:
                assert chunk % (16 // size) == 0
    tiles = lambda m, n: -(-m // 128) * -(-n // 128)   # noqa: E731
    for m, k, n in [(128, 768, 3072), (128, 3072, 768), (32, 768, 768),
                    (32, 768, 2)]:      # batch 1, the pooler, the NSP head
        assert tiles(m, n) * tq.plan_split_k(m, k, n)[0] >= blocks
    for m, k, n in [(4096, 768, 3072), (4096, 3072, 768), (4096, 768, 768)]:
        assert tq.plan_split_k(m, k, n) == (1, k)   # batch 32: no split


# -- B1, bfloat16 -----------------------------------------------------------


def _emulate_b1(q, k, v, bias, sm_scale, causal, block=64):
    """B1's tensor-core arithmetic on bfloat16 q, k, v (float32 bias)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    b, h, sq, d = q.shape
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros(b, h, sq, 1)
    o = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[2], block):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + block])
        s = s * sm_scale
        if bias is not None:
            s = s + bias[..., k0:k0 + block]
        if causal:
            keys = k0 + torch.arange(s.shape[-1])[None, :]
            s = s.masked_fill(keys > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi, lo = _split(p, 2)
        vb = vf[:, :, k0:k0 + block]
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", lo, vb) \
            + torch.einsum("bhqk,bhkd->bhqd", hi, vb)
        m = m_new
    return (o / torch.where(l == 0, torch.ones_like(l), l)) \
        .to(torch.bfloat16)


def _flash_inputs(seed, b, h, s, d, bias):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(b, h, s, d).astype("f4"))
               .to(torch.bfloat16) for _ in range(3))
    if bias == "key":          # BERT's additive key mask
        bias_t = torch.from_numpy(
            np.where(rs.rand(b, 1, 1, s) > 0.1, 0.0, -1e4).astype("f4"))
    else:
        bias_t = None
    return q, k, v, bias_t


def _assert_within_b1_tol(got, want):
    diff = (got.float() - want.float()).abs()
    assert float((diff - TOL - REL_TOL * want.float().abs()).max()) <= 0


@pytest.mark.parametrize("shape,bias,causal", [
    ((2, 2, 128, 64), "key", False),
    ((2, 2, 128, 64), "none", True),
    ((2, 2, 512, 64), "key", False),
])
def test_p_split_meets_the_bfloat16_tolerance(shape, bias, causal):
    q, k, v, b = _flash_inputs(4, *shape, bias)
    scale = 1.0 / np.sqrt(shape[-1])
    got = _emulate_b1(q, k, v, b, scale, causal)
    want = fab.flash_attention_bias_reference(q, k, v, b, sm_scale=scale,
                                              causal=causal)
    _assert_within_b1_tol(got, want)
    if shape[2] == 128:        # and the JAX kernel, interpret mode
        conv = [None if a is None else jnp.asarray(
            a.float().numpy().astype(ml_dtypes.bfloat16) if a.dtype ==
            torch.bfloat16 else a.numpy()) for a in (q, k, v, b)]
        theirs = np.asarray(jflash(*conv, sm_scale=scale, causal=causal,
                                   interpret=True)).astype("f4")
        _assert_within_b1_tol(got, torch.from_numpy(theirs))


def test_all_minus_inf_row_gives_zero():
    q, k, v, _ = _flash_inputs(5, 1, 2, 128, 64, "none")
    bias = torch.zeros(1, 1, 128, 128)
    bias[:, :, [5, 77]] = float("-inf")
    out = _emulate_b1(q, k, v, bias, 0.125, False)
    assert bool((out[:, :, [5, 77]] == 0).all())
    assert bool(torch.isfinite(out.float()).all())
    want = fab.flash_attention_bias_reference(q, k, v, bias, sm_scale=0.125)
    keep = [i for i in range(128) if i not in (5, 77)]
    _assert_within_b1_tol(out[:, :, keep], want[:, :, keep])
