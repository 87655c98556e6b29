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

Both kernels split a row's positions over blocks where the grid would
otherwise leave the card's SMs idle (:func:`plan_split`, from shapes
only: no length is read on the host, so a call never waits for the
card), into a float32 workspace that a second small kernel merges.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ..framework import graphs
from ..native import build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)
_LIB_NAME = "paged_attention"
# The split plan (csrc/paged_attention.cu): the card's SMs, B6's positions
# a key block, and the most page ids one B5 block keeps in shared memory.
_SMS = 132
CHUNK_KEY_BLOCK = 32
DECODE_MAX_SPLIT_PAGES = 64
# B6's query rows a block: 64 (4 warps, two blocks an SM) up to
# CHUNK_WIDE_ROWS rows a call, else 128 (8 warps, one block an SM: the
# staged key block serves twice the rows).
CHUNK_WIDE_ROWS = 64
# Blocks a call should offer before its walk is left whole: B5 four an SM;
# B6 three rounds of the blocks an SM holds.  The shortest range a B6
# block takes: one key block where a call has at most CHUNK_FEW_ROWS rows
# (one warp's products), else two, so that a block's fixed work (the q
# tile, the partials) is spread over more positions.  Chosen on the H100
# among 1-8 blocks an SM (PERF.md, section 6).
DECODE_TARGET_BLOCKS = 4 * _SMS
CHUNK_ROUNDS = 3
CHUNK_FEW_ROWS = 16
_WS_PAD = 4  # a partial is (acc[D], m, l), padded to 16 bytes
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


# -- the split plan -------------------------------------------------------


def plan_split(blocks, pps, page, *, target_blocks, min_positions,
               max_pages=None):
    """How a kernel cuts each row's walk over the page table: ``(nsplit,
    chunk)``, ``nsplit`` ranges of ``chunk`` positions (whole pages)
    that together cover the table's width ``pps * page``; range ``i`` is
    ``[i * chunk, (i + 1) * chunk)``.  ``blocks`` is the grid without a
    split (slots x heads x row tiles).  No split (``nsplit == 1``,
    ``chunk`` the whole width) when that grid already offers
    ``target_blocks``; otherwise enough ranges to offer them, each at
    least ``min_positions`` long, a multiple of B6's key block where
    whole pages allow it, and at most ``max_pages`` pages.  A function
    of shapes only: the lengths stay on the device."""
    pps = max(int(pps), 1)
    want = 1 if blocks >= target_blocks else -(-target_blocks // blocks)
    align = max(CHUNK_KEY_BLOCK // page, 1) \
        if CHUNK_KEY_BLOCK % page == 0 else 1
    pages = max(-(-pps // want), -(-min_positions // page))
    pages = -(-pages // align) * align
    if max_pages is not None:
        pages = min(pages, max_pages)
    pages = max(1, min(pages, pps))
    return -(-pps // pages), pages * page


def plan_decode(s, h, pps, page):
    """B5's plan: ``(nsplit, chunk)`` for ``s`` slots and ``h`` heads."""
    return plan_split(s * h, pps, page, target_blocks=DECODE_TARGET_BLOCKS,
                      min_positions=CHUNK_KEY_BLOCK,
                      max_pages=DECODE_MAX_SPLIT_PAGES)


def chunk_tile_rows(r):
    """B6's query rows a block for a call of ``r`` rows a slot."""
    return 64 if r <= CHUNK_WIDE_ROWS else 128


def plan_chunk(s, r, h, pps, page):
    """B6's plan: ``(nsplit, chunk)`` for ``s`` slots of ``r`` rows and
    ``h`` heads, a block per tile of :func:`chunk_tile_rows` rows."""
    rows = chunk_tile_rows(r)
    resident = 2 if rows == 64 else 1      # blocks an SM holds
    min_positions = CHUNK_KEY_BLOCK * (1 if r <= CHUNK_FEW_ROWS else 2)
    return plan_split(s * h * -(-r // rows), pps, page,
                      target_blocks=CHUNK_ROUNDS * resident * _SMS,
                      min_positions=min_positions)


def _workspace(rows, h, d, nsplit, device):
    """The splits' partials, float32 ``[rows, h, nsplit, d + 4]``: none
    without a split."""
    if nsplit == 1:
        return None
    return torch.empty(rows * h * nsplit * (d + _WS_PAD),
                       dtype=torch.float32, device=device)


# -- kernel wrappers ------------------------------------------------------


def _library():
    global _bound
    lib = build.load(_LIB_NAME)
    if not _bound:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paddle_paged_decode_attention.argtypes = \
            [p] * 9 + [i] * 7 + [f, i, i, p]
        lib.paddle_paged_decode_attention.restype = i
        lib.paddle_paged_chunk_attention.argtypes = \
            [p] * 9 + [i] * 9 + [f, i, i, p]
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
            v_scales, out, ws, dims, sm_scale):
    lib = _library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn_name)(
            _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scales),
            _ptr(v_scales), _ptr(page_table), _ptr(lengths), _ptr(out),
            _ptr(ws), *dims, float(sm_scale), _DTYPE_CODES[q.dtype],
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
    nsplit, chunk = plan_decode(s, h, pps, page)
    _launch("paddle_paged_decode_attention", q, k_pages, v_pages,
            page_table, lengths, k_scales, v_scales, out,
            _workspace(s, h, d, nsplit, q.device),
            (s, h, d, page, pps, nsplit, chunk), sm_scale)
    graphs.count_launch(paged_decode_attention, _COUNT_LOCK, q.device)
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
    nsplit, chunk = plan_chunk(s, r, h, pps, page)
    _launch("paddle_paged_chunk_attention", q, k_pages, v_pages,
            page_table, row_lengths, k_scales, v_scales, out,
            _workspace(s * r, h, d, nsplit, q.device),
            (s, r, h, d, page, pps, nsplit, chunk, chunk_tile_rows(r)),
            sm_scale)
    graphs.count_launch(paged_chunk_attention, _COUNT_LOCK, q.device)
    return out


paged_chunk_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero both kernels' launch counters."""
    with _COUNT_LOCK:
        paged_decode_attention.launches = 0
        paged_chunk_attention.launches = 0
