"""PyTorch port: the flash-attention training op (B2 forward with lse, B3
dq and B4 dk/dv backward).

The port's plain versions of the three kernels -- what the wrappers run
on CPU tensors -- are held against the JAX package's Pallas kernels in
interpret mode on the same numpy inputs, as ``tests/test_flash_attention.py``
runs them: the forward's output AND logsumexp (``fa._fwd_call``), and
dq/dk/dv through ``jax.vjp`` of ``flash_attention(use_pallas=True,
interpret=True)``.  Then the ``torch.autograd.Function`` against autograd
through the plain composition, the mask's missing gradient, the rows with
denominator 0, the argument checks and the op lowering.  The CUDA kernels
run only on the card, where ``chip_smoke.py`` holds each against the same
plain version.

Tolerance, everywhere but where stated: 1e-5 absolute plus 1e-4 relative.
Both sides compute in float32 from the same inputs; they differ in
summation order (the JAX kernels walk 128-wide tiles with an online
softmax, the plain versions sum whole rows) over at most 256 terms of
size O(1).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import flash_attention as jfa
import paddle_tpu_torch as tpkg
from paddle_tpu_torch.framework.lowering import LoweringContext, get_lowering
from paddle_tpu_torch.framework.program import Operator, Program
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused as tfused

from conftest import jax_capability

needs_pallas = pytest.mark.skipif(
    not jax_capability("pallas_interpret"),
    reason="no usable Pallas interpret mode on this jax")

SCALE = 0.125
TOL = dict(atol=1e-5, rtol=1e-4)
B, H, S, D = 1, 2, 256, 64


def _inputs(seed, mask_kind, s=S):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, s, D).astype("f4") for _ in range(3))
    if mask_kind == "none":
        mask = None
    elif mask_kind == "key":
        mask = np.where(rs.rand(B, 1, 1, s) > 0.2, 0.0, -1e9).astype("f4")
    else:
        mask = rs.randn(B, H, s, s).astype("f4")
    return q, k, v, mask


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@needs_pallas
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mask_kind", ["none", "key", "full"])
def test_forward_plain_version_matches_jax_kernel(mask_kind, causal):
    """B2's plain version: out and lse against ``_fwd_call`` in interpret
    mode."""
    q, k, v, mask = _inputs(0, mask_kind)
    want_out, want_lse = jfa._fwd_call(*_j(q, k, v, mask), SCALE, causal,
                                       128, 128, True)
    out, lse = fa.flash_attention_fwd_reference(*_t(q, k, v, mask), SCALE,
                                                causal)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, S)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@needs_pallas
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mask_kind", ["key", "full"])
def test_backward_plain_versions_match_jax_kernels(mask_kind, causal):
    """B3's and B4's plain versions, fed the forward's lse and
    delta = rowsum(do * out), against ``jax.vjp`` through the Pallas
    kernels in interpret mode.  The full mask is the case that catches a
    mask tile read with its two indices swapped."""
    q, k, v, mask = _inputs(1, mask_kind)
    ct = np.random.RandomState(2).randn(B, H, S, D).astype("f4")
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(
            q_, k_, v_, jmask, sm_scale=SCALE, causal=causal,
            use_pallas=True, interpret=True), *_j(q, k, v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(ct))]

    tq, tk, tv, tmask, do = _t(q, k, v, mask, ct)
    out, lse = fa.flash_attention_fwd_reference(tq, tk, tv, tmask, SCALE,
                                                causal)
    delta = (do * out).sum(-1)
    args = (tq, tk, tv, tmask, do, lse, delta, SCALE, causal)
    dq = fa.flash_attention_bwd_dq_reference(*args)
    dk, dv = fa.flash_attention_bwd_dkv_reference(*args)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("mask_kind", ["none", "key", "full"])
def test_autograd_function_matches_autograd_of_the_composition(mask_kind):
    """The kernels take float32/bfloat16 only, so no float64 gradcheck:
    the Function (its plain versions, on CPU tensors) is held against
    torch.autograd through ``flash_attention_ref``, with and without the
    causal mask.  The wrappers count no launch on the CPU."""
    q, k, v, mask = _t(*_inputs(3, mask_kind, s=128))
    ct = torch.from_numpy(
        np.random.RandomState(4).randn(*q.shape).astype("f4"))
    fa.reset_launch_counts()
    for causal in (False, True):
        grads = []
        for use_kernel in (True, False):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fa.flash_attention(*leaves, mask, sm_scale=SCALE,
                                     causal=causal, use_kernel=use_kernel)
            grads.append([out.detach()] + list(
                torch.autograd.grad(out, leaves, ct)))
        for name, got, want in zip(("out", "dq", "dk", "dv"), *grads):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(),
                err_msg=f"{name}, causal={causal}", **TOL)
    assert [f.launches for f in fa.KERNEL_WRAPPERS] == [0, 0, 0]


def test_cpu_default_is_the_composition():
    q, k, v, mask = _t(*_inputs(5, "key", s=128))
    got = fa.flash_attention(q, k, v, mask, sm_scale=SCALE)
    want = fa.flash_attention_ref(q, k, v, mask, sm_scale=SCALE)
    assert torch.equal(got, want)


@needs_pallas
def test_composition_matches_jax_reference_bfloat16_inputs():
    """``flash_attention_ref`` on bfloat16 inputs against the JAX
    package's on the same bits: within one bfloat16 step (2**-7
    relative, 8 significant bits) plus 1e-2 absolute: the two round the
    scores and probabilities to bfloat16 at the same places, but the
    port's softmax sums in float32 as its unfused chain does and the JAX
    reference in bfloat16, so rows of near-equal probabilities move by a
    few steps of 2**-9 (p ~ 1/128) times |v| summed."""
    q, k, v, mask = _inputs(6, "key", s=128)
    tq, tk, tv = (t.bfloat16() for t in _t(q, k, v))
    got = fa.flash_attention_ref(tq, tk, tv, _t(mask)[0], sm_scale=SCALE)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    want = jfa.flash_attention_ref(jq, jk, jv, jnp.asarray(mask),
                                   sm_scale=SCALE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=2.0 ** -7)


def test_mask_gets_no_gradient():
    """The fused op treats the additive mask as a constant (the pass
    refuses learnable masks for the same reason): the JAX package returns
    zeros for it, the port's Function ``None``."""
    q, k, v, mask = _t(*_inputs(7, "key", s=128))
    mask = mask.requires_grad_(True)
    q = q.requires_grad_(True)
    out = fa.flash_attention(q, k, v, mask, sm_scale=SCALE, use_kernel=True)
    dq, dmask = torch.autograd.grad(out.sum(), (q, mask), allow_unused=True)
    assert dmask is None and dq is not None


def test_rows_with_no_live_key_are_zero_and_finite():
    """A row whose mask is -inf everywhere has denominator 0: the forward
    gives out 0 and lse -1e30 (the kernels' l == 0 guard), and the
    backward's exp(S - lse) is exp(-inf) = 0 there, so dq of the row is 0
    and dk/dv stay finite."""
    q, k, v, _ = _t(*_inputs(8, "none", s=128))
    mask = torch.zeros(B, 1, 128, 128)
    mask[:, :, 5, :] = float("-inf")
    out, lse = fa.flash_attention_fwd_reference(q, k, v, mask, SCALE, False)
    assert torch.all(out[:, :, 5] == 0)
    assert torch.all(lse[:, :, 5] == torch.tensor(-1e30))
    do = torch.ones_like(q)
    delta = (do * out).sum(-1)
    args = (q, k, v, mask, do, lse, delta, SCALE, False)
    dq = fa.flash_attention_bwd_dq_reference(*args)
    dk, dv = fa.flash_attention_bwd_dkv_reference(*args)
    assert torch.all(dq[:, :, 5] == 0)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    # the other rows are what they are without the dead row
    want, _ = fa.flash_attention_fwd_reference(q, k, v, None, SCALE, False)
    keep = [i for i in range(128) if i != 5]
    np.testing.assert_allclose(out[:, :, keep].numpy(),
                               want[:, :, keep].numpy(), **TOL)


def test_unaligned_shapes_and_missized_masks_are_loud():
    """The JAX package's messages."""
    q, k, v, _ = _t(*_inputs(9, "none", s=96))
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(q, k, v, use_kernel=True)
    with pytest.raises(ValueError, match="rank"):
        fa.flash_attention(q[0], k[0], v[0])
    q, k, v, _ = _t(*_inputs(9, "none", s=128))
    for shape in ((B, 1, 1, 64), (B, H, 64, 128), (3, 1, 1, 128),
                  (1, 1, 128)):
        with pytest.raises(ValueError, match="does not broadcast"):
            fa.flash_attention(q, k, v, torch.zeros(shape))
    assert fa._shape_ok(128, 256, 64) and not fa._shape_ok(128, 96, 64)
    assert not fa._shape_ok(128, 128, 32)
    assert tfused._shape_ok is fa._shape_ok


def test_cuda_tensors_launch_or_raise():
    """On a CUDA tensor a wrapper launches its kernel or raises; checked
    here with ``meta`` tensors, which reach the argument checks and need
    no card."""
    q = torch.empty(1, 2, 128, 64, device="meta")
    lse = torch.empty(1, 2, 128, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        fa.flash_attention_fwd(q, q, q, None, SCALE, False)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        fa.flash_attention_bwd_dq(q, q, q, None, q, lse, lse, SCALE, False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q.half(), q.half(), q.half(), None, SCALE,
                               False)
    with pytest.raises(ValueError, match="head_dim 32"):
        fa.flash_attention_fwd(q[..., :32].contiguous(),
                               q[..., :32].contiguous(),
                               q[..., :32].contiguous(), None, SCALE, False)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd_dkv(q.transpose(1, 2), q, q, None, q, lse,
                                   lse, SCALE, False)


def _lower(inputs, attrs, env):
    op = Operator(Program().global_block, "flash_attention", inputs,
                  {"Out": ["out"]}, attrs)
    get_lowering("flash_attention")(
        LoweringContext(op.block, env, torch.device("cpu")), op)
    return env["out"]


@pytest.mark.parametrize("engaged", [False, True], ids=["plain", "b2"])
def test_lowering_follows_the_flag(engaged):
    """The ``flash_attention`` op resolves without a side import, reads
    ``scale``/``causal`` and an optional ``Mask``, takes transposed views,
    and follows FLAGS_flash_attention through ``fused._flash_engaged``."""
    q, k, v, mask = _t(*_inputs(10, "key", s=128))
    # as the program hands them over: views of [B, S, H, D]
    env = {n: t.transpose(1, 2).contiguous().transpose(1, 2)
           for n, t in (("q", q), ("k", k), ("v", v))}
    env["m"] = mask
    inputs = {"Q": ["q"], "K": ["k"], "V": ["v"], "Mask": ["m"]}
    tpkg.set_flags({"FLAGS_flash_attention":
                    "always" if engaged else "never"})
    tfused._FORCE_ENGAGE = engaged
    try:
        got = _lower(inputs, {"scale": SCALE, "causal": True}, env)
        no_mask = _lower({s: n for s, n in inputs.items() if s != "Mask"},
                         {"scale": 0.0, "causal": False}, env)
    finally:
        tfused._FORCE_ENGAGE = False
        tpkg.set_flags({"FLAGS_flash_attention": "auto"})
    want = fa.flash_attention_ref(q, k, v, mask, sm_scale=SCALE, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    want = fa.flash_attention_ref(q, k, v, None, sm_scale=1 / 8.0)
    np.testing.assert_allclose(no_mask.numpy(), want.numpy(), **TOL)
