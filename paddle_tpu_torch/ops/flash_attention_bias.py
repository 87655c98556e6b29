"""Flash attention with a streamed additive bias (B1) for the PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas_attention.py``
(``flash_attention_bias``: the Pallas kernel ``_fwd_kernel`` launched by
``_flash_call``, and its q-chunked recompute backward ``_chunked_bwd``)::

    q, k, v : [B, H, S, D]  float32 or bfloat16, S % 128 == 0,
                            D in (64, 128, 256)
    bias    : None, a key mask [B|1, H|1, 1, Sk] or a full
              [B|1, H|1, Sq, Sk] tensor, float32 or bfloat16, read in its
              natural shape (never broadcast to [B, H, Sq, Sk])
    out     : softmax(q k^T * sm_scale + bias [+ causal -1e30 mask]) v,
              every sum in float32, rounded to q's dtype; a row whose
              denominator is 0 returns 0 (the TPU kernel's l == 0 guard)

``flash_attention_bias`` launches the forward kernel written by hand in
CUDA C++ for Hopper (``csrc/flash_attention.cu``, built by
``native/build.py``) when its tensors lie on a CUDA device, and raises
when it cannot: there is no fallback on the card.  q runs on the tensor
cores (``flash_fwd_mma_kernel``: the probabilities split into two
bfloat16 pieces for P V, and float32 q, k, v into three, so the result
keeps the float32 contract), but float32 at head dim 256 on the CUDA
cores (``flash_fwd_kernel``).  Tensors on the CPU
take the plain PyTorch version beside it,
``flash_attention_bias_reference``.  ``flash_attention_bias.launches``
counts the kernel launches.

The gradient is a ``torch.autograd.Function``: its backward is a
plain-torch port of the JAX package's ``_chunked_bwd`` (the JAX package
computes it outside any Pallas kernel too), returning dq, dk, dv and a
dbias reduced over the bias's broadcast dims.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..framework import graphs
from ..native import build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
SEQ_BLOCK = 128  # the TPU kernel's block; the sequence contract keeps it
_LIB_NAME = "flash_attention"
_bound = False
_COUNT_LOCK = threading.Lock()


# -- plain version --------------------------------------------------------


def _scores(q, k, bias, sm_scale, causal, row0=0):
    """float32 scores of q rows ``row0..`` against every key, with the
    bias (its rows ``row0..`` when it has a query dim) and causal mask."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        b = bias.float()
        if b.shape[2] != 1:
            b = b[:, :, row0:row0 + q.shape[2]]
        s = s + b
    if causal:
        rows = row0 + torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    return s


def flash_attention_bias_reference(q, k, v, bias=None, *, sm_scale=None,
                                   causal=False):
    """Plain version of B1: the masked-softmax composition, every
    intermediate in float32, the output rounded to q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_scores(q, k, bias, sm_scale, causal), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _chunked_bwd(q, k, v, bias, do, sm_scale, causal, block_q=SEQ_BLOCK):
    """dq/dk/dv/dbias with O(block_q * Sk) live scores: a loop over q
    chunks accumulating dk/dv (and a broadcast-reduced dbias), the port
    of ``paddle_tpu/ops/pallas_attention.py:_chunked_bwd``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kf, vf = k.float(), v.float()
    dk = torch.zeros(b, h, sk, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq_chunks, db_chunks = [], []
    db_acc = None
    bias_q_bcast = bias is not None and bias.shape[2] == 1
    for off in range(0, sq, block_q):
        qc = q[:, :, off:off + block_q].float()
        doc = do[:, :, off:off + block_q].float()
        p = torch.softmax(_scores(qc, k, bias, sm_scale, causal, off), -1)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, doc)
        dp = torch.einsum("bhqd,bhkd->bhqk", doc, vf)
        delta = (p * dp).sum(-1, keepdim=True)
        ds_raw = p * (dp - delta)       # = dL/ds before the qk scale
        ds = ds_raw * sm_scale
        dq_chunks.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf))
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc)
        if bias is not None:
            db = ds_raw    # dL/dbias contribution of this q chunk
            if bias.shape[1] == 1:
                db = db.sum(1, keepdim=True)
            if bias.shape[0] == 1:
                db = db.sum(0, keepdim=True)
            if bias_q_bcast:
                db = db.sum(2, keepdim=True)
                db_acc = db if db_acc is None else db_acc + db
            else:
                db_chunks.append(db)
    dq = torch.cat(dq_chunks, dim=2)
    dbias = None
    if bias is not None:
        dbias = (db_acc if bias_q_bcast else torch.cat(db_chunks, dim=2)) \
            .to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# -- kernel wrapper -------------------------------------------------------


def _library():
    global _bound
    lib = build.load(_LIB_NAME)
    if not _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, bias, out; B, H, Sq, Sk, D; bias strides (b, h, q);
        # sm_scale, causal, q dtype, bias dtype; stream
        lib.paddle_flash_attention_bias_fwd.argtypes = \
            [p] * 5 + [i] * 5 + [i] * 3 + [f, i, i, i, p]
        lib.paddle_flash_attention_bias_fwd.restype = i
        lib.paddle_flash_cuda_error_string.argtypes = [i]
        lib.paddle_flash_cuda_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def _check_args(q, k, v, bias, block_q=SEQ_BLOCK, block_k=SEQ_BLOCK):
    """The JAX package's contract (``pallas_attention.py:255-271``):
    sequences multiples of the block, a bias that broadcasts to
    ``(B, H, Sq, Sk)`` with the key dim exactly Sk."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention_bias: q, k, v must be [B, H, S, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention_bias: k and v must both be [B, H, Sk, D] = "
            f"[{b}, {h}, Sk, {d}], got {tuple(k.shape)} and "
            f"{tuple(v.shape)}")
    if sq % block_q or sk % block_k:
        raise ValueError(
            f"flash_attention_bias needs seq multiples of the block "
            f"({block_q}/{block_k}); got Sq={sq}, Sk={sk}")
    if bias is not None:
        ok = (bias.dim() == 4
              and bias.shape[0] in (1, b) and bias.shape[1] in (1, h)
              and bias.shape[2] in (1, sq) and bias.shape[3] == sk)
        if not ok:
            raise ValueError(
                f"bias shape {tuple(bias.shape)} does not broadcast to "
                f"(B={b}, H={h}, Sq={sq}, Sk={sk}); the key dim must be "
                f"exactly Sk")


def _check_launch(q, k, v, bias, what="flash_attention_bias"):
    """What the kernels take beyond the shape contract; raise on the rest
    (``what`` names the calling op in the message)."""
    tensors = [t for t in (q, k, v, bias) if t is not None]
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(
            f"{what}: every tensor must lie on one device, "
            f"got {sorted({str(t.device) for t in tensors})}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"{what}: q, k, v must share one dtype of "
            f"float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if bias is not None and bias.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: bias must be float32 or "
                         f"bfloat16, got {bias.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[-1]} "
                         f"not in {HEAD_DIMS}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: every tensor must be "
                         "contiguous")
    if bias is not None and bias.numel() >= 2 ** 31:
        raise ValueError(f"{what}: the kernel addresses the "
                         "bias with 32-bit strides; got "
                         f"{bias.numel()} elements")
    if dev.type != "cuda":
        raise RuntimeError(
            f"{what}: the kernel runs on CUDA tensors only "
            f"(the plain version takes CPU tensors), got {dev}")


def _bias_strides(bias):
    """Element strides of the bias over (b, h, query); 0 along a
    broadcast dim, so the kernel reads the bias in its natural shape."""
    if bias is None:
        return 0, 0, 0
    bb, bh, bq, bk = bias.shape
    return (0 if bb == 1 else bh * bq * bk, 0 if bh == 1 else bq * bk,
            0 if bq == 1 else bk)


def _forward(q, k, v, bias, sm_scale, causal):
    """The forward: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if all(t.device.type == "cpu" for t in (q, k, v, bias) if t is not None):
        return flash_attention_bias_reference(q, k, v, bias,
                                              sm_scale=sm_scale,
                                              causal=causal)
    _check_launch(q, k, v, bias)
    out = torch.empty_like(q)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bias_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, sq, sk, d, *_bias_strides(bias), float(sm_scale),
            int(bool(causal)), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[bias.dtype] if bias is not None else 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_bias launch failed: CUDA error {rc} "
            f"({lib.paddle_flash_cuda_error_string(rc).decode()})")
    graphs.count_launch(flash_attention_bias, _COUNT_LOCK, q.device)
    return out


class _FlashAttentionBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, causal):
        ctx.save_for_backward(q, k, v, bias)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return _forward(q, k, v, bias, sm_scale, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = _chunked_bwd(q, k, v, bias, do, ctx.sm_scale,
                                         ctx.causal)
        return dq, dk, dv, dbias, None, None


def flash_attention_bias(q, k, v, bias=None, *, sm_scale=None,
                         causal=False):
    """Flash attention over [B, H, S, D] tensors with a streamed additive
    bias (B1): ``bias`` is None, a key mask [B|1, H|1, 1, Sk] or a full
    [B|1, H|1, Sq, Sk] tensor.  Differentiable (q-chunked recompute
    backward).  CUDA tensors launch the kernel; CPU tensors take
    :func:`flash_attention_bias_reference`."""
    _check_args(q, k, v, bias)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttentionBias.apply(q, k, v, bias, float(sm_scale),
                                     bool(causal))


flash_attention_bias.launches = 0


def reset_launch_count() -> None:
    """Zero the kernel's launch counter."""
    with _COUNT_LOCK:
        flash_attention_bias.launches = 0
