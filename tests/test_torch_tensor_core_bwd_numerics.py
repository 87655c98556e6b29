"""PyTorch port: the arithmetic of the tensor-core flash-attention backward
(B3 dq, B4 dk/dv), emulated on the CPU.

``csrc/flash_attention_bwd.cu`` takes the backward's products on Hopper's
tensor cores in bfloat16 with float32 accumulation, yet is held to the
float32 tolerance ``chip_smoke.py`` gives it (``BWD_TOL``: 1e-4 absolute,
plus one bfloat16 step, 2**-7 |plain|, for bfloat16 results).  These tests
redo its steps in torch on the CPU, with inputs made from a seed with numpy:

- a float32 operand (q, k, v, do) is split into three bfloat16 pieces, P
  and dS into two (``_split``, the kernels' split), and each product takes
  the piece pairs (i, j) with i + j < max(pieces): 6 bfloat16 products for
  S = q k^T and dP = do v^T, 5 for dq = dS k, dk = dS^T q and dv = P^T do;
  bfloat16 operands are exact in one piece (1 and 2 products);
- S, P = exp(S * scale + mask - lse) and dS = P (dP - delta) scale element
  by element in float32, as the kernels take them;
- every walked block's share of dq (64 keys for bfloat16, 32 for float32)
  and of dk, dv (32 queries) summed on its own, then added to a float32
  sum.

The result is held to ``flash_attention_bwd_dq_reference`` /
``flash_attention_bwd_dkv_reference`` within ``BWD_TOL``, and in float32
within half of it, the margin the kernel's design keeps for the tensor
cores' accumulation, which this emulation cannot reproduce (a float32 sum
stands in for it).  Two pieces an operand exceed that half; the emulation
also meets the JAX package's kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as fa
from test_torch_tensor_core_numerics import _split

from conftest import jax_capability

needs_pallas = pytest.mark.skipif(
    not jax_capability("pallas_interpret"),
    reason="no usable Pallas interpret mode on this jax")

BWD_TOL, REL_TOL = 1e-4, 2.0 ** -7   # chip_smoke.py's B3/B4 tolerance
HALF = 0.5                           # the float32 design margin
NEG_INF = -1e30


def _product(a, b, eq):
    """The piece products a[i] b[j] with i + j < max(len(a), len(b)), the
    smaller first, summed in float32."""
    top = max(len(a), len(b))
    pairs = sorted(((i, j) for i in range(len(a)) for j in range(len(b))
                    if i + j < top), key=lambda ij: -sum(ij))
    out = 0
    for i, j in pairs:
        out = out + torch.einsum(eq, a[i], b[j])
    return out


def _emulate_bwd(q, k, v, mask, do, lse, delta, scale, causal,
                 pieces=None, p_pieces=2):
    """B3's and B4's arithmetic: (dq, dk, dv) in the inputs' dtype.
    ``pieces``: bfloat16 pieces of a float32 operand (3, the kernels');
    ``p_pieces``: of P and dS (2)."""
    if pieces is None:
        pieces = 3 if q.dtype == torch.float32 else 1
    qp, kp, vp, dop = (_split(t.float(), pieces) for t in (q, k, v, do))
    s = _product(qp, kp, "bhqd,bhkd->bhqk") * scale
    if mask is not None:
        s = s + mask.float()
    sq, sk = s.shape[-2:]
    if causal:
        s = s.masked_fill(torch.arange(sq)[:, None] < torch.arange(sk),
                          NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = _product(dop, vp, "bhqd,bhkd->bhqk")
    ds = p * (dp - delta[..., None]) * scale
    dq, dk, dv = (torch.zeros(t.shape) for t in (q, k, v))
    kb = 64 if q.dtype == torch.bfloat16 else 32     # B3's walked keys
    for k0 in range(0, sk, kb):
        dq = dq + _product(_split(ds[..., k0:k0 + kb], p_pieces),
                           [t[:, :, k0:k0 + kb] for t in kp],
                           "bhqk,bhkd->bhqd")
    for r0 in range(0, sq, 32):                       # B4's walked queries
        rows = slice(r0, r0 + 32)
        ds_t, p_t = (x[:, :, rows].transpose(-1, -2) for x in (ds, p))
        dk = dk + _product(_split(ds_t, p_pieces),
                           [t[:, :, rows] for t in qp], "bhkq,bhqd->bhkd")
        dv = dv + _product(_split(p_t, p_pieces),
                           [t[:, :, rows] for t in dop], "bhkq,bhqd->bhkd")
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _case(seed, b, h, s, d, dtype, mask_kind):
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(b, h, s, d).astype("f4"))
                   .to(dtype) for _ in range(4))
    if mask_kind == "key":         # BERT's additive key mask
        mask = np.where(rs.rand(b, 1, 1, s) > 0.1, 0.0, -1e4)
    elif mask_kind == "full":
        mask = rs.randn(b, h, s, s)
    else:
        mask = None
    if mask is not None:
        mask = torch.from_numpy(mask.astype("f4")).to(dtype)
    return q, k, v, mask, do


def _operands(q, k, v, mask, do, causal):
    """The backward's operands as the op's Function gives them: lse from
    the forward, delta = rowsum(do * out)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = fa.flash_attention_fwd_reference(q, k, v, mask, scale, causal)
    delta = (do.float() * out.float()).sum(-1)
    return (q, k, v, mask, do, lse, delta, scale, causal)


def _plain(args):
    return (fa.flash_attention_bwd_dq_reference(*args),
            *fa.flash_attention_bwd_dkv_reference(*args))


def _share(got, want):
    """The largest |got - want| over BWD_TOL (+ one bfloat16 step)."""
    rel = REL_TOL if want.dtype == torch.bfloat16 else 0.0
    diff = (got.float() - want.float()).abs()
    return float((diff / (BWD_TOL + rel * want.float().abs())).max())


@pytest.mark.parametrize("dtype,s,d,mask_kind,causal", [
    ("float32", 128, 64, "key", False),       # the main path's call
    ("float32", 128, 64, "full", False),
    ("float32", 128, 64, "none", True),
    ("float32", 512, 64, "key", False),       # the longest sum
    ("float32", 128, 128, "key", False),      # the second head width
    ("bfloat16", 128, 64, "key", False),
    ("bfloat16", 128, 64, "full", False),
    ("bfloat16", 128, 64, "none", True),
    ("bfloat16", 512, 64, "key", False),
])
def test_split_backward_meets_the_tolerance(dtype, s, d, mask_kind, causal):
    args = _operands(*_case(0, 2, 2, s, d, getattr(torch, dtype), mask_kind),
                     causal)
    limit = HALF if dtype == "float32" else 1.0
    for name, got, want in zip(("dq", "dk", "dv"), _emulate_bwd(*args),
                               _plain(args)):
        assert got.dtype == want.dtype
        assert _share(got, want) <= limit, name


def test_two_pieces_an_operand_exceed_half_the_tolerance():
    """Causal float32 attention at B = H = 8: two bfloat16 pieces an
    operand (16 bits) leave more than half of BWD_TOL; three keep within
    it on the same inputs."""
    args = _operands(*_case(1, 8, 8, 128, 64, torch.float32, "none"), True)
    want = _plain(args)
    two = max(_share(g, w) for g, w in zip(_emulate_bwd(*args, pieces=2),
                                           want))
    three = max(_share(g, w) for g, w in zip(_emulate_bwd(*args), want))
    assert two > HALF >= three


def test_one_piece_fails_the_tolerance():
    """Operands rounded once to bfloat16 (8 bits) miss BWD_TOL itself."""
    args = _operands(*_case(2, 2, 2, 128, 64, torch.float32, "key"), False)
    got = _emulate_bwd(*args, pieces=1)
    assert max(_share(g, w) for g, w in zip(got, _plain(args))) > 1.0


def test_p_and_ds_in_one_piece_fail_the_tolerance():
    """P and dS rounded once to bfloat16 miss BWD_TOL even where the
    operands are exact (bfloat16 inputs): they take two pieces."""
    args = _operands(*_case(3, 2, 2, 128, 64, torch.bfloat16, "key"), False)
    got = _emulate_bwd(*args, p_pieces=1)
    assert max(_share(g, w) for g, w in zip(got, _plain(args))) > 1.0


def test_dead_rows_give_zero_dq_and_finite_dk_dv():
    """Rows whose mask is -inf at every key (lse -1e30): P = 0 there, so dq
    is exactly 0 and dk, dv stay finite and within the tolerance."""
    q, k, v, _mask, do = _case(4, 2, 2, 128, 64, torch.float32, "none")
    mask = torch.zeros(2, 1, 128, 128)
    mask[:, :, [5, 77]] = float("-inf")
    args = _operands(q, k, v, mask, do, False)
    assert bool((args[5][:, :, [5, 77]] == NEG_INF).all())
    got = _emulate_bwd(*args)
    assert bool((got[0][:, :, [5, 77]] == 0).all())
    for g, w in zip(got, _plain(args)):
        assert bool(torch.isfinite(g).all()) and _share(g, w) <= HALF


def _jax_array(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


@needs_pallas
@pytest.mark.parametrize("dtype,mask_kind,causal", [
    ("float32", "key", False), ("float32", "full", True),
    ("bfloat16", "key", False)])
def test_emulation_meets_the_jax_kernels(dtype, mask_kind, causal):
    """dq, dk, dv of the emulation against ``jax.vjp`` through the JAX
    package's Pallas kernels in interpret mode (their own forward's lse and
    delta), at S = 128."""
    q, k, v, mask, do = _case(5, 1, 2, 128, 64, getattr(torch, dtype),
                              mask_kind)
    jmask = _jax_array(mask)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(
            q_, k_, v_, jmask, sm_scale=0.125, causal=causal,
            use_pallas=True, interpret=True), *map(_jax_array, (q, k, v)))
    theirs = [torch.from_numpy(np.asarray(g).astype("f4")).to(q.dtype)
              for g in vjp(_jax_array(do))]
    got = _emulate_bwd(*_operands(q, k, v, mask, do, causal))
    for name, g, w in zip(("dq", "dk", "dv"), got, theirs):
        assert _share(g, w) <= 1.0, name
