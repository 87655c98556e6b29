"""Fused flash-attention training op: forward + tiled recompute backward
as one ``torch.autograd.Function`` (B2, B3, B4) for the PyTorch port.

Counterpart of ``paddle_tpu/ops/flash_attention.py`` (the Pallas kernels
``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` behind one
``jax.custom_vjp``).  This is the op the graph pass
``framework/passes.py:FlashAttentionPass`` rewrites the unfused
matmul -> mask-add -> softmax -> matmul chain (and its grad chain) to::

    q, k, v : [B, H, S, D]  float32 or bfloat16, S % 128 == 0,
                            D in (64, 128, 256)
    mask    : None, a key mask [B|1, H|1, 1, Sk] or a full
              [B|1, H|1, Sq, Sk] tensor, float32 or bfloat16, read in its
              natural shape; a CONSTANT (padding/causal masks): it gets
              no gradient, and the pass refuses chains whose mask wants
              one
    out     : softmax(q k^T * sm_scale + mask [+ causal -1e30 mask]) v

Memory shape, which is the point: the forward (B2) keeps one score tile
at a time and writes the output plus one float32 logsumexp per row,
``lse = m + log(l)`` (O(N)); the backward RECOMPUTES the probabilities
tile by tile from (q, k, v, lse) as ``exp(S - lse)`` in two kernels, dq
(B3: key blocks stream past a resident dq tile) and dk/dv (B4: query
blocks stream past resident dk/dv tiles).  ``delta = rowsum(do * out)``
is one O(N*D) pass in plain torch, as the JAX package takes it in jnp.

The three kernels are written by hand in CUDA C++ for Hopper
(``csrc/flash_attention.cu``: ``flash_fwd_kernel`` with its lse store;
``csrc/flash_attention_bwd.cu``: ``flash_bwd_dq_kernel`` and
``flash_bwd_dkv_kernel``; built by ``native/build.py``).  Each wrapper
(``flash_attention_fwd``, ``flash_attention_bwd_dq``,
``flash_attention_bwd_dkv``) launches its kernel when its tensors lie on
a CUDA device and raises when it cannot: there is no fallback on the
card.  Tensors on the CPU take the plain PyTorch version beside it
(``*_reference``, float32 inside).  ``<wrapper>.launches`` counts the
kernel's launches.

``flash_attention_ref`` is the masked-softmax composition the unfused op
chain lowers to: the lowering's path when the kernels are not engaged,
and the rewrite's numerical oracle.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..framework.lowering import register_lower
from ..monitor import stat_add
from ..native import build
from .flash_attention_bias import (_COUNT_LOCK, _DTYPE_CODES, _NEG_INF,
                                   HEAD_DIMS, SEQ_BLOCK, _bias_strides,
                                   _check_launch, _scores)
from .flash_attention_bias import _library as _fwd_library

_BWD_LIB_NAME = "flash_attention_bwd"
_bound = set()


# -- the composition (CPU default; the rewrite's numerical oracle) ---------


def flash_attention_ref(q, k, v, mask=None, *, sm_scale, causal=False):
    """Plain masked-softmax attention over (B, H, S, D): exactly the
    composition the unfused matmul/add/softmax/matmul chain lowers to
    (scores in the inputs' type, the softmax's exp and sum in float32,
    probabilities back in the inputs' type), so a pass rewrite to this
    path is loss-parity-safe."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if mask is not None:
        s = s + mask.to(s.dtype)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s.float(), dim=-1).to(s.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


# -- plain versions of the three kernels ----------------------------------


def flash_attention_fwd_reference(q, k, v, mask, sm_scale, causal):
    """Plain version of B2: ``(out, lse)``, float32 inside.  The running
    max starts at -1e30 as the kernel's does, so a row whose scores are
    all -inf has denominator 0: out 0, lse -1e30."""
    s = _scores(q, k, mask, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / safe
    lse = torch.where(l == 0, torch.full_like(l, _NEG_INF),
                      m + torch.log(safe))
    return out.to(q.dtype), lse.squeeze(-1)


def _recompute(q, k, v, mask, do, lse, delta, sm_scale, causal):
    """float32 (P, dS) of the backward's recompute: P = exp(S - lse) with
    the difference taken after the mask add, dS = P (dP - delta) scale."""
    s = _scores(q, k, mask, sm_scale, causal)
    p = torch.exp(s - lse.float().unsqueeze(-1))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta.float().unsqueeze(-1)) * sm_scale
    return p, ds


def flash_attention_bwd_dq_reference(q, k, v, mask, do, lse, delta,
                                     sm_scale, causal):
    """Plain version of B3: dq = dS k, float32 inside, in q's dtype."""
    _p, ds = _recompute(q, k, v, mask, do, lse, delta, sm_scale, causal)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, mask, do, lse, delta,
                                      sm_scale, causal):
    """Plain version of B4: (dk, dv) = (dS^T q, P^T do), float32 inside,
    in k's and v's dtypes."""
    p, ds = _recompute(q, k, v, mask, do, lse, delta, sm_scale, causal)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers ------------------------------------------------------


def _bwd_library():
    lib = build.load(_BWD_LIB_NAME)
    if "bwd" not in _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, bias, do, lse, delta, outputs; B, H, Sq, Sk, D; bias
        # strides (b, h, q); sm_scale, causal, q dtype, bias dtype; stream
        tail = [i] * 5 + [i] * 3 + [f, i, i, i, p]
        lib.paddle_flash_attention_bwd_dq.argtypes = [p] * 8 + tail
        lib.paddle_flash_attention_bwd_dq.restype = i
        lib.paddle_flash_attention_bwd_dkv.argtypes = [p] * 9 + tail
        lib.paddle_flash_attention_bwd_dkv.restype = i
        lib.paddle_flash_bwd_cuda_error_string.argtypes = [i]
        lib.paddle_flash_bwd_cuda_error_string.restype = ctypes.c_char_p
        _bound.add("bwd")
    return lib


def _fwd_lse_library():
    lib = _fwd_library()
    if "fwd" not in _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paddle_flash_attention_fwd_lse.argtypes = \
            [p] * 6 + [i] * 5 + [i] * 3 + [f, i, i, i, p]
        lib.paddle_flash_attention_fwd_lse.restype = i
        _bound.add("fwd")
    return lib


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check_stats(q, do, lse, delta):
    """The backward's extra operands, beyond what ``_check_launch`` holds
    q, k, v and the mask to."""
    b, h, sq, _d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(
                f"flash_attention backward: {name} must be a contiguous "
                f"float32 [{b}, {h}, {sq}] tensor on {q.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError(
            f"flash_attention backward: do must be contiguous, "
            f"{tuple(q.shape)} {q.dtype} on {q.device} like q, got "
            f"{tuple(do.shape)} {do.dtype} on {do.device}")


def _launch_args(q, k, mask, sm_scale, causal):
    b, h, sq, d = q.shape
    return (b, h, sq, k.shape[2], d, *_bias_strides(mask), float(sm_scale),
            int(bool(causal)), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[mask.dtype] if mask is not None else 0,
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc, what, error_string):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({error_string(rc).decode()})")


def _count(fn):
    with _COUNT_LOCK:
        fn.launches += 1


def flash_attention_fwd(q, k, v, mask, sm_scale, causal):
    """B2: ``(out, lse)``.  The kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if _on_cpu(q, k, v, mask):
        return flash_attention_fwd_reference(q, k, v, mask, sm_scale, causal)
    _check_launch(q, k, v, mask, what="flash_attention")
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _fwd_lse_library()
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_fwd_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            out.data_ptr(), lse.data_ptr(),
            *_launch_args(q, k, mask, sm_scale, causal))
    _raise_on(rc, "flash_attention forward",
              lib.paddle_flash_cuda_error_string)
    _count(flash_attention_fwd)
    return out, lse


def flash_attention_bwd_dq(q, k, v, mask, do, lse, delta, sm_scale, causal):
    """B3: dq.  The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if _on_cpu(q, k, v, mask, do, lse, delta):
        return flash_attention_bwd_dq_reference(q, k, v, mask, do, lse,
                                                delta, sm_scale, causal)
    _check_launch(q, k, v, mask, what="flash_attention")
    _check_stats(q, do, lse, delta)
    dq = torch.empty_like(q)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_launch_args(q, k, mask, sm_scale, causal))
    _raise_on(rc, "flash_attention dq backward",
              lib.paddle_flash_bwd_cuda_error_string)
    _count(flash_attention_bwd_dq)
    return dq


def flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta, sm_scale, causal):
    """B4: ``(dk, dv)``.  The kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if _on_cpu(q, k, v, mask, do, lse, delta):
        return flash_attention_bwd_dkv_reference(q, k, v, mask, do, lse,
                                                 delta, sm_scale, causal)
    _check_launch(q, k, v, mask, what="flash_attention")
    _check_stats(q, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_launch_args(q, k, mask, sm_scale, causal))
    _raise_on(rc, "flash_attention dk/dv backward",
              lib.paddle_flash_bwd_cuda_error_string)
    _count(flash_attention_bwd_dkv)
    return dk, dv


KERNEL_WRAPPERS = (flash_attention_fwd, flash_attention_bwd_dq,
                   flash_attention_bwd_dkv)
for _fn in KERNEL_WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    """Zero the three kernels' launch counters."""
    with _COUNT_LOCK:
        for fn in KERNEL_WRAPPERS:
            fn.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale, causal):
        out, lse = flash_attention_fwd(q, k, v, mask, sm_scale, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        do = do.contiguous()
        # delta_i = do_i . o_i: one O(N*D) pass shared by both kernels,
        # in float32 from the saved output (bfloat16 under bf16 inputs)
        delta = (do.float() * out.float()).sum(dim=-1)
        args = (q, k, v, mask, do, lse, delta, ctx.sm_scale, ctx.causal)
        dq = flash_attention_bwd_dq(*args)
        dk, dv = flash_attention_bwd_dkv(*args)
        # the mask is a constant (padding/causal masks): no gradient by
        # contract -- the graph pass refuses chains whose mask wants one
        return dq, dk, dv, None, None, None


# -- public entry + op lowering -------------------------------------------


def _shape_ok(sq, sk, d):
    """What the kernels take: sequences multiples of the 128 block, a head
    dim they are instantiated for."""
    return sq % SEQ_BLOCK == 0 and sk % SEQ_BLOCK == 0 and d in HEAD_DIMS


def _check_mask(mask, b, h, sq, sk):
    if mask is None:
        return
    # a mis-sized mask would be read out of bounds through the broadcast
    # strides instead of erroring
    ok = (mask.dim() == 4
          and mask.shape[0] in (1, b) and mask.shape[1] in (1, h)
          and mask.shape[2] in (1, sq) and mask.shape[3] == sk)
    if not ok:
        raise ValueError(
            f"mask shape {tuple(mask.shape)} does not broadcast to "
            f"(B={b}, H={h}, Sq={sq}, Sk={sk}); the key dim must be "
            f"exactly Sk")


def flash_attention(q, k, v, mask=None, *, sm_scale=None, causal=False,
                    use_kernel=None):
    """Fused attention over (B, H, S, D) q/k/v with an optional additive
    mask (None, key form [B,1,1,Sk], or full [B,H,Sq,Sk]).

    ``use_kernel``: True forces the kernel path (B2 forward, B3/B4
    backward; on CPU tensors their plain versions), False forces the
    masked-softmax composition, None picks the kernels for CUDA tensors at
    kernel-aligned shapes and the composition everywhere else -- the CPU
    default stays the plain composition.  Differentiable in q/k/v (tiled
    recompute backward on the kernel path); the mask is treated as a
    constant there."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention wants (B, H, S, D) inputs; "
                         f"got rank {q.dim()}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_mask(mask, b, h, sq, sk)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if use_kernel is None:
        use_kernel = q.device.type == "cuda" and _shape_ok(sq, sk, d)
    if not use_kernel:
        return flash_attention_ref(q, k, v, mask, sm_scale=sm_scale,
                                   causal=causal)
    if sq % SEQ_BLOCK or sk % SEQ_BLOCK:
        raise ValueError(
            f"flash_attention needs seq multiples of the block "
            f"({SEQ_BLOCK}/{SEQ_BLOCK}); got Sq={sq}, Sk={sk}")
    return _FlashAttention.apply(q, k, v, mask, float(sm_scale),
                                 bool(causal))


@register_lower("flash_attention")
def _flash_attention_lower(ctx, op):
    """The op ``FlashAttentionPass`` emits.  ``flash_attention_grad``
    carries ``__fwd_type__ = "flash_attention"`` and takes the generic
    gradient, which replays this lowering under autograd (with no random
    generator: nothing here draws) and pulls back through B3 and B4."""
    from . import fused

    q = ctx.in1(op, "Q")
    k = ctx.in1(op, "K")
    v = ctx.in1(op, "V")
    mask = ctx.in1(op, "Mask")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    sm_scale = float(op.attr("scale", 0.0)) or 1.0 / math.sqrt(d)
    causal = bool(op.attr("causal", False))
    if fused._flash_engaged(b, h, sq, sk, d, q.device):
        stat_add("flash_attention_engaged")
        # q, k, v arrive as transposed views of [B, S, H, D]
        out = flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            None if mask is None else mask.contiguous(),
            sm_scale=sm_scale, causal=causal, use_kernel=True)
    else:
        out = flash_attention(q, k, v, mask, sm_scale=sm_scale,
                              causal=causal, use_kernel=False)
    ctx.set_out(op, "Out", out)
