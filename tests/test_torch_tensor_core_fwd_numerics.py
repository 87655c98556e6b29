"""PyTorch port: the arithmetic of the tensor-core flash-attention forward
(B1, and B2 with its logsumexp) on float32 inputs, emulated on the CPU.

``csrc/flash_attention.cu`` (``flash_fwd_mma_kernel``) takes the forward's
products on Hopper's tensor cores in bfloat16 with float32 accumulation,
yet is held to the float32 tolerance ``chip_smoke.py`` gives it (``TOL``:
3e-5 absolute, on out and on lse).  These tests redo its steps in torch on
the CPU, with inputs made from a seed with numpy:

- float32 q, k, v are split into three bfloat16 pieces, P into two
  (``_split``, the kernel's split), and each product takes the piece pairs
  (i, j) with i + j < max(pieces), the smaller first (``_product``): 6
  bfloat16 products for S = q k^T, 5 for P V;
- the scores are kept in base-2 units (log2(e) folded into the scale and
  the bias, exp2), the running max starting at -1e30, over 32-key blocks;
- each key block's P V is summed on its own and added to the running
  output, O = O alpha + fresh, as the kernel adds its fresh fragment on the
  CUDA cores;
- lse = (m + log2 l) ln 2, and exactly -1e30 where l == 0.

out and lse are held to ``flash_attention_fwd_reference`` (and out to
``flash_attention_bias_reference``) within half of ``TOL``, the margin the
design keeps for the tensor cores' accumulation, which this emulation
cannot reproduce (a float32 sum stands in for it).  Two pieces an operand
exceed that half and P in one piece misses the tolerance itself; the
emulation also meets the JAX package's kernels in interpret mode.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops.pallas_attention import flash_attention_bias as jflash
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_attention_bias as fab
from test_torch_tensor_core_bwd_numerics import _product
from test_torch_tensor_core_numerics import _split

from conftest import jax_capability

needs_pallas = pytest.mark.skipif(
    not jax_capability("pallas_interpret"),
    reason="no usable Pallas interpret mode on this jax")

TOL = 3e-5        # chip_smoke.py's float32 tolerance of B1 and B2
HALF = 0.5        # the float32 design margin
NEG_INF = -1e30
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
KEY_BLOCK = 32    # the float32 kernel's key block


def _emulate_fwd(q, k, v, bias, scale, causal, pieces=3, p_pieces=2):
    """The float32 kernel's arithmetic: (out, lse).  ``pieces``: bfloat16
    pieces of q, k and v (3, the kernel's); ``p_pieces``: of P (2)."""
    qp, kp, vp = (_split(t.float(), pieces) for t in (q, k, v))
    b, h, sq, d = q.shape
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros(b, h, sq, 1)
    o = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[2], KEY_BLOCK):
        blk = slice(k0, k0 + KEY_BLOCK)
        x = _product(qp, [t[:, :, blk] for t in kp], "bhqd,bhkd->bhqk") \
            * (scale * LOG2E)
        if bias is not None:
            x = x + bias[..., blk].float() * LOG2E
        if causal:
            keys = k0 + torch.arange(x.shape[-1])[None, :]
            x = x.masked_fill(keys > rows, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        fresh = _product(_split(p, p_pieces), [t[:, :, blk] for t in vp],
                         "bhqk,bhkd->bhqd")
        o = o * alpha + fresh
        m = m_new
    safe = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF),
                      (m + torch.log2(safe)) * LN2)
    return (o / safe).to(q.dtype), lse.squeeze(-1)


def _case(seed, b, h, s, d, bias_kind):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(b, h, s, d).astype("f4"))
               for _ in range(3))
    if bias_kind == "key":       # BERT's additive key mask
        bias = np.where(rs.rand(b, 1, 1, s) > 0.1, 0.0, -1e4)
    elif bias_kind == "full":
        bias = rs.randn(b, h, s, s)
    else:
        bias = None
    if bias is not None:
        bias = torch.from_numpy(bias.astype("f4"))
    return q, k, v, bias


def _share(got, want):
    """The largest |got - want| over TOL."""
    return float(((got.float() - want.float()).abs() / TOL).max())


def _shares(q, k, v, bias, causal, **kw):
    """Shares of TOL of the emulation's out and lse against the plain
    version's."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = _emulate_fwd(q, k, v, bias, scale, causal, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, bias,
                                                          scale, causal)
    return _share(out, want_out), _share(lse, want_lse)


@pytest.mark.parametrize("s,d,bias_kind,causal", [
    (128, 64, "key", False),      # the main path's call
    (128, 64, "full", False),
    (128, 64, "none", False),
    (128, 64, "none", True),
    (128, 64, "key", True),
    (512, 64, "key", False),      # the longest sum
    (512, 64, "full", True),
    (128, 128, "key", False),     # the second head width
])
def test_split_forward_meets_the_tolerance(s, d, bias_kind, causal):
    q, k, v, bias = _case(0, 2, 2, s, d, bias_kind)
    out_share, lse_share = _shares(q, k, v, bias, causal)
    assert out_share <= HALF and lse_share <= HALF


def test_emulation_meets_b1s_plain_version():
    """B1's plain version is a softmax: the same out on rows that are not
    dead."""
    q, k, v, bias = _case(1, 2, 2, 128, 64, "full")
    out, _lse = _emulate_fwd(q, k, v, bias, 0.125, False)
    want = fab.flash_attention_bias_reference(q, k, v, bias, sm_scale=0.125)
    assert out.dtype == want.dtype == torch.float32
    assert _share(out, want) <= HALF


def test_two_pieces_an_operand_exceed_half_the_tolerance():
    """Causal float32 attention at B = H = 4: two bfloat16 pieces of q, k
    and v (16 bits) leave more than half of TOL on out; three keep within
    it on the same inputs."""
    q, k, v, bias = _case(2, 4, 4, 128, 64, "none")
    two = _shares(q, k, v, bias, True, pieces=2)[0]
    three = _shares(q, k, v, bias, True)[0]
    assert two > HALF >= three


def test_p_in_one_piece_fails_the_tolerance():
    """P rounded once to bfloat16 (8 bits) misses TOL itself, even with q,
    k and v in three pieces."""
    q, k, v, bias = _case(3, 2, 2, 128, 64, "key")
    assert _shares(q, k, v, bias, False, p_pieces=1)[0] > 1.0


def test_dead_rows_give_zero_out_and_lse_minus_1e30():
    """Rows whose bias is -inf at every key: every p is 0, so out is
    exactly 0 and lse exactly -1e30 (not -1e30 ln 2), as in the plain
    version; the other rows stay within the tolerance."""
    q, k, v, _ = _case(4, 2, 2, 128, 64, "none")
    bias = torch.zeros(2, 1, 128, 128)
    bias[:, :, [5, 77]] = float("-inf")
    out, lse = _emulate_fwd(q, k, v, bias, 0.125, False)
    assert bool((out[:, :, [5, 77]] == 0).all())
    assert bool((lse[:, :, [5, 77]] == NEG_INF).all())
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, bias,
                                                          0.125, False)
    assert _share(out, want_out) <= HALF and _share(lse, want_lse) <= HALF


def _jax_array(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


@needs_pallas
@pytest.mark.parametrize("bias_kind,causal", [("key", False),
                                              ("full", True)])
def test_emulation_meets_the_jax_kernels(bias_kind, causal):
    """out and lse of the emulation against the JAX package's B2 kernel
    (``_fwd_call``), and out against its B1 kernel, both in interpret mode,
    at S = 128."""
    q, k, v, bias = _case(5, 1, 2, 128, 64, bias_kind)
    out, lse = _emulate_fwd(q, k, v, bias, 0.125, causal)
    args = [_jax_array(t) for t in (q, k, v, bias)]
    b2_out, b2_lse = jfa._fwd_call(*args, 0.125, causal, 128, 128, True)
    b1_out = jflash(*args, sm_scale=0.125, causal=causal, interpret=True)
    for got, theirs in ((out, b2_out), (lse, b2_lse), (out, b1_out)):
        assert _share(got, torch.from_numpy(np.array(theirs))) <= HALF
