"""Paged decode and chunk attention for the PyTorch port.

Counterpart of ``paddle_tpu/ops/pallas_decode_attention.py``: the
serving engine's attention reads one layer's K/V page pool straight
through each slot's page table (``serving/kv_cache.py``)::

    q          : [S, H, D]  (decode)  or  [S, R, H, D]  (chunk)
    k/v_pages  : [P, page, H, D]      one layer's pool
    page_table : [S, pps]  int32      slot -> ordered page ids
    lengths    : [S] int32 (decode)  or  row_lengths [S, R] int32

Position ``t`` of a row takes part iff ``t < length``.  Quantized pools
are int8 with ``k_scales``/``v_scales`` ``[P, page, H]`` float32, one
scale per position and head, applied before the one masked softmax.

Each wrapper launches a kernel written by hand in CUDA C++ for Hopper
(``csrc/paged_attention.cu``, built by ``native/build.py``) when its
tensors lie on a CUDA device, and raises when it cannot: there is no
fallback on the card.  Tensors on the CPU take the plain PyTorch
version beside it, the gather-then-mask formulation of the JAX
reference.  ``paged_decode_attention.launches`` and
``paged_chunk_attention.launches`` count the kernel launches.

Contract details shared by kernels and plain versions:

- lengths are clamped to the page table's width ``pps * page``;
- a row with no live position returns 0 (the TPU kernels' ``l == 0``
  guard; the JAX ``decode_attention_reference`` returns the mean of V
  there instead, and the engine never asks for such a row);
- the output has q's dtype, every sum is taken in float32.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ..native import build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)
_LIB_NAME = "paged_attention"
_bound = False
_COUNT_LOCK = threading.Lock()  # engine threads of several replicas


# -- plain versions -------------------------------------------------------


def _gather_dequant(pages, scales, page_table):
    """Gather each slot's pages to full width ``[S, pps*page, H, D]``
    in float32, dequantized when a scale pool rides along."""
    s, pps = page_table.shape
    idx = page_table.long()
    g = pages[idx].float()                   # [S, pps, page, H, D]
    if scales is not None:
        g = g * scales[idx].float()[..., None]
    return g.reshape(s, pps * pages.shape[1], *pages.shape[2:])


def paged_chunk_attention_reference(q, k_pages, v_pages, page_table,
                                    row_lengths, *, sm_scale=None,
                                    k_scales=None, v_scales=None):
    """Plain version of B6: gather the page table to full width, mask
    ``t >= row_length`` to -1e30, softmax, weight V.  Row r of slot s
    attends over slot s's gathered K/V without materializing one copy
    per row."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    k = _gather_dequant(k_pages, k_scales, page_table)
    v = _gather_dequant(v_pages, v_scales, page_table)
    s = torch.einsum("srhd,sthd->srht", q.float(), k) * sm_scale
    t = torch.arange(k.shape[1], device=q.device)
    lens = row_lengths.to(torch.int64)
    live = t[None, None, None, :] < lens[:, :, None, None]
    p = torch.softmax(s.masked_fill(~live, _NEG_INF), dim=-1)
    out = torch.einsum("srht,sthd->srhd", p, v)
    # a row with no live position returns 0, as the kernels do
    out = torch.where((lens > 0)[:, :, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     lengths, *, sm_scale=None,
                                     k_scales=None, v_scales=None):
    """Plain version of B5: the chunk formulation at one row per slot."""
    return paged_chunk_attention_reference(
        q[:, None], k_pages, v_pages, page_table, lengths[:, None],
        sm_scale=sm_scale, k_scales=k_scales, v_scales=v_scales)[:, 0]


# -- kernel wrappers ------------------------------------------------------


def _library():
    global _bound
    lib = build.load(_LIB_NAME)
    if not _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paddle_paged_decode_attention.argtypes = \
            [p] * 8 + [i] * 5 + [f, i, i, p]
        lib.paddle_paged_decode_attention.restype = i
        lib.paddle_paged_chunk_attention.argtypes = \
            [p] * 8 + [i] * 6 + [f, i, i, p]
        lib.paddle_paged_chunk_attention.restype = i
        lib.paddle_cuda_error_string.argtypes = [i]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def _all_on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check_launch(name, q, k_pages, v_pages, page_table, lengths,
                  k_scales, v_scales):
    """Validate what the kernel takes; raise on anything else.  ``q`` is
    ``[S, H, D]`` for decode or ``[S, R, H, D]`` for chunk, ``lengths``
    ``q.shape[:-2]``."""
    tensors = [t for t in (q, k_pages, v_pages, page_table, lengths,
                           k_scales, v_scales) if t is not None]
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: every tensor must lie on one device, got "
            f"{sorted({str(t.device) for t in tensors})}")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if k_pages.dtype not in _DTYPE_CODES or v_pages.dtype != k_pages.dtype:
        raise ValueError(
            f"{name}: k/v pages must share one dtype of float32, bfloat16 "
            f"or int8, got {k_pages.dtype} and {v_pages.dtype}")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"{name}: k/v pages must both be [P, page, H, D], got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    h, d = k_pages.shape[2:]
    if tuple(q.shape[-2:]) != (h, d):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the "
                         f"pool's (H, D) = {(h, d)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scales is not None) or \
            (k_scales is None) != (v_scales is None):
        raise ValueError(
            f"{name}: int8 pages need k_scales and v_scales, and float "
            f"pages take none")
    if quantized:
        for sc in (k_scales, v_scales):
            if sc.dtype != torch.float32 or \
                    tuple(sc.shape) != tuple(k_pages.shape[:3]):
                raise ValueError(
                    f"{name}: scales must be float32 [P, page, H] = "
                    f"{tuple(k_pages.shape[:3])}, got {sc.dtype} "
                    f"{tuple(sc.shape)}")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != q.shape[0]:
        raise ValueError(
            f"{name}: page_table must be int32 [S, pps] with S = "
            f"{q.shape[0]}, got {page_table.dtype} "
            f"{tuple(page_table.shape)}")
    if lengths.dtype != torch.int32 or \
            tuple(lengths.shape) != tuple(q.shape[:-2]):
        raise ValueError(
            f"{name}: lengths must be int32 {tuple(q.shape[:-2])}, got "
            f"{lengths.dtype} {tuple(lengths.shape)}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if dev.type != "cuda":
        raise RuntimeError(
            f"{name}: the kernel runs on CUDA tensors only (the plain "
            f"version takes CPU tensors), got {dev}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn_name, q, k_pages, v_pages, page_table, lengths, k_scales,
            v_scales, out, dims, sm_scale):
    lib = _library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn_name)(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scales),
            _ptr(v_scales), _ptr(page_table), _ptr(lengths), _ptr(out),
            *dims, float(sm_scale), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: CUDA error {rc} "
            f"({lib.paddle_cuda_error_string(rc).decode()})")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           sm_scale=None, k_scales=None, v_scales=None):
    """Decode attention straight off the page pool (B5): one query row
    per slot.  q [S,H,D]; k/v_pages [P,page,H,D]; page_table [S,pps]
    int32; lengths [S] int32; ``k_scales``/``v_scales`` [P,page,H] arm
    the int8 path.  CUDA tensors launch the kernel; CPU tensors take
    :func:`paged_decode_attention_reference`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _all_on_cpu(q, k_pages, v_pages, page_table, lengths, k_scales,
                   v_scales):
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, lengths, sm_scale=sm_scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.dim() != 3:
        raise ValueError(f"paged_decode_attention: q must be [S, H, D], "
                         f"got {tuple(q.shape)}")
    _check_launch("paged_decode_attention", q, k_pages, v_pages,
                  page_table, lengths, k_scales, v_scales)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    s, h, d = q.shape
    page, pps = k_pages.shape[1], page_table.shape[1]
    _launch("paddle_paged_decode_attention", q, k_pages, v_pages,
            page_table, lengths, k_scales, v_scales, out,
            (s, h, d, page, pps), sm_scale)
    with _COUNT_LOCK:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_chunk_attention(q, k_pages, v_pages, page_table, row_lengths, *,
                          sm_scale=None, k_scales=None, v_scales=None):
    """Multi-row attention off the page pool (B6): R query rows per
    slot, row r of slot s attending positions ``t < row_lengths[s, r]``.
    Serves the whole-prompt prefill (S=1, R=padded prompt), the
    prefix-hit suffix prefill and chunked prefill.  q [S,R,H,D];
    row_lengths [S,R] int32; pools, table and scales as
    :func:`paged_decode_attention`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _all_on_cpu(q, k_pages, v_pages, page_table, row_lengths, k_scales,
                   v_scales):
        return paged_chunk_attention_reference(
            q, k_pages, v_pages, page_table, row_lengths, sm_scale=sm_scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.dim() != 4:
        raise ValueError(f"paged_chunk_attention: q must be [S, R, H, D], "
                         f"got {tuple(q.shape)}")
    _check_launch("paged_chunk_attention", q, k_pages, v_pages, page_table,
                  row_lengths, k_scales, v_scales)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    s, r, h, d = q.shape
    page, pps = k_pages.shape[1], page_table.shape[1]
    _launch("paddle_paged_chunk_attention", q, k_pages, v_pages,
            page_table, row_lengths, k_scales, v_scales, out,
            (s, r, h, d, page, pps), sm_scale)
    with _COUNT_LOCK:
        paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero both kernels' launch counters."""
    with _COUNT_LOCK:
        paged_decode_attention.launches = 0
        paged_chunk_attention.launches = 0
