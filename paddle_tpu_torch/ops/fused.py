"""Fused multi-head attention, flash-kernel engagement by flag.

Counterpart of ``paddle_tpu/ops/fused.py``.  One op, two lowerings:

- the plain composition (``_plain_attention``, the JAX package's: scores
  in the inputs' type, a float32 softmax, probabilities back in the
  inputs' type);
- the flash kernel B1 (``ops/flash_attention_bias.py``) for biased and
  unbiased attention alike: it streams the additive mask block by block
  (the JAX package also sends unbiased attention on the TPU to JAX's
  library flash kernel; B1 at ``bias=None`` computes the same).

Engagement follows FLAGS_flash_attention (auto/always/never) with the JAX
package's rule, a CUDA tensor standing where the JAX package requires
the TPU backend: 'always' engages at every aligned shape, 'auto' only
when the float32 score tensor would pass 2 GB.  ``_FORCE_ENGAGE`` lets
tests engage it on CPU tensors, where B1's wrapper runs its plain
version.  Both lowerings are differentiable, so the generic gradient
(ops/grad_generic.py) replays either unchanged.
"""
from __future__ import annotations

import math

import torch

from ..framework.flags import flag
from ..framework.lowering import register_lower
from .flash_attention_bias import flash_attention_bias


def _plain_attention(q, k, v, bias, sm_scale, causal=False):
    """Reference composition: softmax((q k^T) * scale + bias) v, float32
    softmax internals, inputs' dtype out."""
    dt = q.dtype
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1).to(dt)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


_FORCE_ENGAGE = False  # tests: engage B1 on CPU tensors (its plain version)


def _shape_ok(sq, sk, d):
    return sq % 128 == 0 and sk % 128 == 0 and d in (64, 128, 256)


def _flash_engaged(b, h, sq, sk, d, device) -> bool:
    """FLAGS_flash_attention engagement.  The JAX package measured XLA's
    own attention fusion matching its flash kernel at BERT's shapes, so
    'auto' engages only when the plain path's float32 score tensor would
    threaten device memory (> 2 GB); 'always' engages at any aligned
    shape; 'never' forces the plain path."""
    mode = str(flag("flash_attention"))
    if mode == "never" or not _shape_ok(sq, sk, d):
        return False
    if not (_FORCE_ENGAGE or device.type == "cuda"):
        return False
    if mode == "always":
        return True
    return 4 * b * h * sq * sk > (2 << 30)


@register_lower("fused_multihead_attention")
def _fused_mha(ctx, op):
    q = ctx.in1(op, "Q")
    k = ctx.in1(op, "K")
    v = ctx.in1(op, "V")
    bias = ctx.in1(op, "BiasQK")  # additive mask, [B,1,1,S] or [B,H,S,S]
    if bool(op.attr("sequence_parallel", False)):
        raise NotImplementedError(
            "fused_multihead_attention(sequence_parallel=True) needs ring "
            "attention over an 'sp' mesh axis: a later slice of the port")
    n_heads = int(op.attr("head_number", op.attr("num_heads", 1)))
    b, s, hidden = q.shape
    d = hidden // n_heads
    sm_scale = float(op.attr("alpha", 0.0)) or 1.0 / math.sqrt(d)
    causal = bool(op.attr("causal", False))

    def heads(x):
        return x.reshape(b, s, n_heads, d).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    if _flash_engaged(b, n_heads, s, s, d, q.device):
        out = flash_attention_bias(
            qh.contiguous(), kh.contiguous(), vh.contiguous(),
            None if bias is None else bias.contiguous(),
            sm_scale=sm_scale, causal=causal)
    else:
        out = _plain_attention(qh, kh, vh, bias, sm_scale, causal=causal)
    ctx.set_out(op, "Out", out.transpose(1, 2).reshape(b, s, hidden))
