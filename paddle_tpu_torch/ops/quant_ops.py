"""Fake quantization, weight-only int8 / fp8 quantization and the
dequant-fused matmul (B7).

Counterpart of ``paddle_tpu/ops/quant_ops.py``:

- the ten fake-quant lowerings (reference operators/fake_quantize_op.cc:
  ``fake_quantize_abs_max``, ``fake_channel_wise_quantize_abs_max``,
  ``fake_quantize_moving_average_abs_max``, ``fake_quantize_range_abs_max``,
  their ``*_dequantize_*`` variants, ``moving_average_abs_max_scale`` and
  the two ``fake_*dequantize_max_abs`` ops), which simulate the int8 grid
  in float as the JAX package does.  The quant-dequant variants carry a
  straight-through estimator, ``x + (qdq(x) - x).detach()``, so the
  generic gradient (``ops/grad_generic.py``), which replays the forward
  under autograd, passes the output's gradient through unchanged.  State
  (the moving averages, the range ring buffer and its ``Iter``) is read
  from its input slots and written to its output slots, which name the
  same persistable vars: the executor writes them back in place, inside
  the captured step, as it does optimizer state.  The ring buffer is
  indexed with the ``Iter`` tensor, never a host copy of it.  Every
  division whose result must match the CPU bit for bit divides by a
  tensor (see ``quantize_weight``), and the outputs keep ``X``'s dtype;

- ``quantize_weight`` / ``dequantize_weight`` (and their per-expert
  ``*_stacked`` forms for ``[E, ...]`` MoE weights, scales ``[E, out]``):
  symmetric per-output-channel quantization to an int8 grid or to float8 e4m3
  (``torch.float8_e4m3fn``), every channel's scale clamped to
  ``SCALE_EPS`` on its own, so that an all-zero channel dequantizes to
  exact zeros;
- ``dequant_matmul``: ``x [M, K] @ (q [K, N] * scale [N])`` with float32
  accumulation, the output at ``out_dtype`` (x's by default).  On CUDA
  tensors it launches B7, the kernel written by hand in CUDA C++ for
  Hopper (``csrc/dequant_matmul.cu``, built by ``native/build.py``), at
  every shape: the TPU kernel's tiles leave shapes they do not divide to
  the jnp reference, the port's kernel guards its edges instead.  The
  kernel multiplies on the tensor cores in bfloat16 (float32 x as three
  bfloat16 pieces, the carrier exact) and splits K where M is small
  (``plan_split_k``; the partial sums go to a float32 workspace this
  module allocates).  Tensors
  on the CPU take the plain version, ``dequant_matmul_reference``, which
  keeps the JAX reference's order (dequantize in float32, then matmul);
  so does ``use_pallas="never"`` (the op attr keeps its name: op attrs
  are the IR's contract).  ``dequant_matmul.launches`` counts the kernel's
  launches;
- ``lower_dequant_matmul``: the ``dequant_matmul`` op that
  ``slim.PostTrainingWeightQuantPass`` rewrites ``mul``/``matmul``/
  ``matmul_v2`` into, with every branch of the JAX lowering (flattening
  dims, transposes, ``alpha``, and dequantize-then-matmul for weights
  that are not 2-D or not column-scaled);
- ``quant_quality_delta``: the quantization tax against a float oracle,
  mirrored onto the same monitor gauges.

``SCALE_EPS`` is also the clamp of the int8 KV cache
(``serving/kv_cache.py``).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..framework import graphs
from ..framework.lowering import register_lower
from ..framework.scope import to_numpy, to_tensor
from .common import as_scalar
from ..native import build

# the ONE scale clamp, shared by every scale computation.  It must be
# applied to the PER-SLICE maxima (elementwise), never only to a global
# max: an all-zero channel/page otherwise yields a ~0 scale and the
# dequant divides by it
SCALE_EPS = 1e-8

INT8_QMAX = 127.0
FP8_E4M3_MAX = 448.0  # largest finite float8_e4m3 magnitude

WEIGHT_QUANT_MODES = ("int8", "fp8_e4m3")

_LIB_NAME = "dequant_matmul"
# the kernel's output tile, and the blocks that fill the card (H100: 132
# SMs); a grid of fewer tiles splits K
TILE_M = TILE_N = 128
SPLIT_K_BLOCKS = 132
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound = False
_COUNT_LOCK = threading.Lock()


def _fp8_dtype():
    """torch's float8 e4m3 type (None on a torch without one)."""
    return getattr(torch, "float8_e4m3fn", None)


def _w_codes():
    codes = {torch.int8: 0}
    if _fp8_dtype() is not None:
        codes[_fp8_dtype()] = 1
    return codes


def resolve_quant_mode(mode: str) -> str:
    """Validate a weight-quant mode string, degrading ``fp8_e4m3`` to
    ``int8`` (counted as ``quant_fp8_unavailable``) when the installed
    torch lacks the dtype."""
    if mode not in WEIGHT_QUANT_MODES:
        raise ValueError(
            f"unknown weight-quant mode {mode!r}; expected one of "
            f"{WEIGHT_QUANT_MODES}")
    if mode == "fp8_e4m3" and _fp8_dtype() is None:
        from ..monitor import stat_add

        stat_add("quant_fp8_unavailable")
        return "int8"
    return mode


def _clamp_scale(scale):
    """Clamp scale(s) away from zero -- elementwise, so every slice of a
    per-channel scale tensor is individually protected."""
    return torch.clamp_min(scale, SCALE_EPS)


def quantize_weight(w, axis: int, mode: str = "int8"):
    """Post-training weight quantization: ``w`` -> ``(carrier, scale)``
    with per-output-channel step sizes along ``axis`` (the scale is
    clamped PER CHANNEL, so an all-zero channel dequantizes to exact
    zeros instead of dividing by ~0).  ``carrier * scale`` reconstructs
    the weight; int8 carriers hold the rounded grid (round half to even,
    as ``jnp.round``), fp8 carriers the scaled value itself (rounded to
    nearest even, as the JAX package's cast).  Both are made on ``w``'s
    device."""
    w = to_tensor(w)
    mode = resolve_quant_mode(mode)
    red = tuple(i for i in range(w.dim()) if i != axis)
    amax = torch.amax(w.abs(), dim=red)
    # divide by a tensor, not a Python number: on CUDA tensors torch turns
    # a division by a host scalar into a multiplication by its reciprocal,
    # which rounds differently, and the carriers would then differ from
    # the ones the same weights give on the CPU (and in the JAX package)
    qmax = torch.full((), INT8_QMAX if mode == "int8" else FP8_E4M3_MAX,
                      dtype=amax.dtype, device=amax.device)
    scale = _clamp_scale(amax / qmax)
    bshape = [1] * w.dim()
    bshape[axis] = -1
    return _carrier_of(w / scale.reshape(bshape), mode), \
        scale.to(torch.float32)


def dequantize_weight(q, scale, axis: int, dtype=torch.float32):
    """Inverse of :func:`quantize_weight` (the plain path -- B7 does the
    same per tile in shared memory)."""
    bshape = [1] * q.dim()
    bshape[axis] = -1
    return (q.float() * scale.float().reshape(bshape)).to(dtype)


def _carrier_of(scaled, mode):
    if mode == "int8":
        return torch.clamp(torch.round(scaled), -INT8_QMAX, INT8_QMAX) \
            .to(torch.int8)
    return torch.clamp(scaled, -FP8_E4M3_MAX, FP8_E4M3_MAX) \
        .to(_fp8_dtype())


def quantize_weight_stacked(w, axis: int, mode: str = "int8"):
    """Per-expert variant of :func:`quantize_weight` for stacked
    ``[E, ...]`` MoE weights: the scale keeps BOTH the leading stack axis
    and the output-channel ``axis`` (shape ``[E, out]``), so each expert
    calibrates its own step sizes -- a shared scale would let one hot
    expert's outliers crush every other expert's resolution."""
    w = to_tensor(w)
    if w.dim() < 2 or axis == 0:
        raise ValueError(
            f"stacked quantization needs a [E, ...] weight with an "
            f"output-channel axis != 0, got shape {tuple(w.shape)} axis "
            f"{axis}")
    mode = resolve_quant_mode(mode)
    red = tuple(i for i in range(w.dim()) if i not in (0, axis))
    amax = torch.amax(w.abs(), dim=red) if red else w.abs()
    qmax = torch.full((), INT8_QMAX if mode == "int8" else FP8_E4M3_MAX,
                      dtype=amax.dtype, device=amax.device)
    scale = _clamp_scale(amax / qmax)
    bshape = [1] * w.dim()
    bshape[0] = w.shape[0]
    bshape[axis] = w.shape[axis]
    return _carrier_of(w / scale.reshape(bshape), mode), \
        scale.to(torch.float32)


def dequantize_weight_stacked(q, scale, axis: int, dtype=torch.float32):
    """Inverse of :func:`quantize_weight_stacked`."""
    bshape = [1] * q.dim()
    bshape[0] = q.shape[0]
    bshape[axis] = q.shape[axis]
    return (q.float() * scale.float().reshape(bshape)).to(dtype)


# -- the fake-quant lowerings ----------------------------------------------


def _qmax(op):
    return 2.0 ** (int(op.attr("bit_length", 8)) - 1) - 1


def _like(value, x):
    """``value`` as a 0-dim tensor of ``x``'s dtype on ``x``'s device: a
    divisor that divides (on CUDA a Python divisor becomes a multiplication
    by its reciprocal, which rounds differently from the CPU)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _abs_max(x):
    return _clamp_scale(torch.amax(x.abs()))


def _channel_abs_max(x, axis):
    red = tuple(i for i in range(x.dim()) if i != axis)
    return _clamp_scale(torch.amax(x.abs(), dim=red) if red else x.abs())


def _quant(x, scale, qmax):
    """Quantize to the integer grid, kept in float (the reference outputs
    float tensors holding integer values); round half to even, as
    ``jnp.round``."""
    return torch.clamp(torch.round(x / scale * qmax), -qmax, qmax)


def _qdq_ste(x, scale, qmax):
    """Quant-dequant with a straight-through gradient."""
    q = _quant(x, scale, qmax)
    qdq = q * scale / _like(qmax, q)
    return x + (qdq - x).detach()


def _bshape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = -1
    return shape


@register_lower("fake_quantize_abs_max")
def lower_fake_quantize_abs_max(ctx, op):
    x = ctx.in1(op, "X")
    scale = _abs_max(x)
    ctx.set_out(op, "Out", _quant(x, scale, _qmax(op)).to(x.dtype))
    ctx.set_out(op, "OutScale", scale.reshape(1))


@register_lower("fake_quantize_dequantize_abs_max")
def lower_fake_quantize_dequantize_abs_max(ctx, op):
    x = ctx.in1(op, "X")
    scale = _abs_max(x)
    ctx.set_out(op, "Out", _qdq_ste(x, scale, _qmax(op)).to(x.dtype))
    ctx.set_out(op, "OutScale", scale.reshape(1))


@register_lower("fake_channel_wise_quantize_abs_max")
def lower_fake_channel_wise_quantize_abs_max(ctx, op):
    x = ctx.in1(op, "X")
    axis = int(op.attr("quant_axis", 0))
    scale = _channel_abs_max(x, axis)
    ctx.set_out(op, "Out", _quant(x, scale.reshape(_bshape(x, axis)),
                                  _qmax(op)).to(x.dtype))
    ctx.set_out(op, "OutScale", scale)


@register_lower("fake_channel_wise_quantize_dequantize_abs_max")
def lower_fake_channel_wise_qdq_abs_max(ctx, op):
    x = ctx.in1(op, "X")
    axis = int(op.attr("quant_axis", 0))
    scale = _channel_abs_max(x, axis)
    ctx.set_out(op, "Out", _qdq_ste(x, scale.reshape(_bshape(x, axis)),
                                    _qmax(op)).to(x.dtype))
    ctx.set_out(op, "OutScale", scale)


def _moving_average_scale(ctx, op, x):
    """Shared accumulator update (fake_quantize_op.cc FindMovingAverage):
    state = rate*state + 1;  accum = rate*accum + abs_max(x);
    scale = accum / state.  In is_test mode the stored scale is used
    unchanged and no state is written."""
    rate = float(op.attr("moving_rate", 0.9))
    in_scale = as_scalar(ctx.in1(op, "InScale"))
    if op.attr("is_test", False):
        return torch.clamp_min(in_scale, 1e-8), None, None
    state = as_scalar(ctx.in1(op, "InState"))
    accum = as_scalar(ctx.in1(op, "InAccum"))
    state = rate * state + 1.0
    accum = rate * accum + _abs_max(x)
    return torch.clamp_min(accum / state, 1e-8), state, accum


def _emit_moving_average_state(ctx, op, scale, state, accum):
    ctx.set_out(op, "OutScale", scale.reshape(1))
    if state is not None:
        ctx.set_out(op, "OutState", state.reshape(1))
        ctx.set_out(op, "OutAccum", accum.reshape(1))


@register_lower("fake_quantize_moving_average_abs_max")
def lower_fake_quantize_moving_average_abs_max(ctx, op):
    x = ctx.in1(op, "X")
    scale, state, accum = _moving_average_scale(ctx, op, x)
    ctx.set_out(op, "Out", _quant(x, scale, _qmax(op)).to(x.dtype))
    _emit_moving_average_state(ctx, op, scale, state, accum)


@register_lower("fake_quantize_dequantize_moving_average_abs_max")
def lower_fake_qdq_moving_average_abs_max(ctx, op):
    x = ctx.in1(op, "X")
    scale, state, accum = _moving_average_scale(ctx, op, x)
    ctx.set_out(op, "Out", _qdq_ste(x, scale, _qmax(op)).to(x.dtype))
    _emit_moving_average_state(ctx, op, scale, state, accum)


@register_lower("fake_quantize_range_abs_max")
def lower_fake_quantize_range_abs_max(ctx, op):
    """Windowed running-max scale (fake_quantize_op.cc FindRangeAbsMax):
    a [window_size] ring buffer of per-step abs-maxes; the scale is the
    max over the window.  The slot is ``Iter % window``, taken on the
    device (``index_put``), so the step needs no host read."""
    x = ctx.in1(op, "X")
    qmax = _qmax(op)
    if op.attr("is_test", False):
        scale = torch.clamp_min(as_scalar(ctx.in1(op, "InScale")), 1e-8)
        ctx.set_out(op, "Out", _quant(x, scale, qmax).to(x.dtype))
        return
    window = int(op.attr("window_size", 10000))
    cur = _abs_max(x)
    scales = ctx.in1(op, "InScales")
    it = ctx.in1(op, "Iter").reshape(1)
    if scales is None:  # windowless degenerate form: running max
        prev = as_scalar(ctx.in1(op, "InScale"))
        scale = torch.clamp_min(torch.maximum(prev, cur.to(prev.dtype)),
                                1e-8)
    else:
        scales = scales.clone().index_put_(
            (torch.remainder(it, window).long(),),
            cur.to(scales.dtype).reshape(1))
        scale = torch.clamp_min(torch.amax(scales), 1e-8)
        ctx.set_out(op, "OutScales", scales)
    ctx.set_out(op, "Out", _quant(x, scale, qmax).to(x.dtype))
    ctx.set_out(op, "OutScale", scale.reshape(1))
    ctx.set_out(op, "OutIter", it + 1)


@register_lower("moving_average_abs_max_scale")
def lower_moving_average_abs_max_scale(ctx, op):
    """Observer only: Out = X unchanged, scale state updated (used by the
    reference's OutScaleForTrainingPass)."""
    x = ctx.in1(op, "X")
    scale, state, accum = _moving_average_scale(ctx, op, x)
    if ctx.out_name(op, "Out"):
        ctx.set_out(op, "Out", x)
    _emit_moving_average_state(ctx, op, scale, state, accum)


@register_lower("fake_dequantize_max_abs")
def lower_fake_dequantize_max_abs(ctx, op):
    x = ctx.in1(op, "X")
    scale = as_scalar(ctx.in1(op, "Scale"))
    out = x * scale
    max_range = float(op.attr("max_range", 127.0))
    ctx.set_out(op, "Out", (out / _like(max_range, out)).to(x.dtype))


@register_lower("fake_channel_wise_dequantize_max_abs")
def lower_fake_channel_wise_dequantize_max_abs(ctx, op):
    x = ctx.in1(op, "X")
    scales = ctx.in_list(op, "Scales")
    axis = int(op.attr("quant_axis", 0))
    bits = op.attr("quant_bits", [8])
    out = x * scales[0].reshape(_bshape(x, axis))
    out = out / _like(2.0 ** (int(bits[0]) - 1) - 1, out)
    if len(scales) > 1:  # second-level (whole-tensor) scale, mul path
        out = out * as_scalar(scales[1])
        out = out / _like(2.0 ** (int(bits[1]) - 1) - 1, out)
    ctx.set_out(op, "Out", out.to(x.dtype))


# -- B7: plain version and kernel wrapper ---------------------------------


def dequant_matmul_reference(x, qw, scale, out_dtype=None):
    """Plain version of B7, in the JAX reference's order: the weight
    dequantized in float32, a float32 matmul, the result cast to
    ``out_dtype`` (x's dtype by default)."""
    w = qw.float() * scale.float()[None, :]
    return (x.float() @ w).to(out_dtype or x.dtype)


def plan_split_k(m: int, k: int, n: int, x_itemsize: int = 4):
    """How B7 cuts K: ``(splits, k_chunk)`` with ``splits * k_chunk >=
    k`` and every split non-empty.  A grid of at least ``SPLIT_K_BLOCKS``
    output tiles takes K whole; a smaller one cuts K into chunks, each a
    multiple of one 16-byte copy of x (4 float32 or 8 bfloat16 values),
    until the tiles times the splits reach ``SPLIT_K_BLOCKS`` or the
    chunks are one copy wide."""
    align = 16 // x_itemsize
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    if tiles >= SPLIT_K_BLOCKS or k <= align:
        return 1, k
    want = -(-SPLIT_K_BLOCKS // tiles)
    chunk = max(align, k // want // align * align)
    splits = -(-k // chunk)
    return (1, k) if splits == 1 else (splits, chunk)


def _library():
    global _bound
    lib = build.load(_LIB_NAME)
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, q, scale, out, workspace; M, K, N; splits, k_chunk; x, w, out
        # dtypes; stream
        lib.paddle_dequant_matmul.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.paddle_dequant_matmul.restype = i
        lib.paddle_dequant_cuda_error_string.argtypes = [i]
        lib.paddle_dequant_cuda_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def _check_args(x, qw, scale):
    """The op's shape contract, on every device."""
    if x.dim() != 2 or qw.dim() != 2 or scale.dim() != 1:
        raise ValueError(
            f"dequant_matmul: x must be [M, K], the carrier [K, N] and the "
            f"scale [N]; got {tuple(x.shape)}, {tuple(qw.shape)}, "
            f"{tuple(scale.shape)}")
    if x.shape[1] != qw.shape[0] or scale.shape[0] != qw.shape[1]:
        raise ValueError(
            f"dequant_matmul: shapes {tuple(x.shape)} @ {tuple(qw.shape)} "
            f"with scale {tuple(scale.shape)} do not chain")


def _check_launch(x, qw, scale, out_dtype):
    """What the kernel takes beyond the shape contract; raise on the
    rest."""
    what = "dequant_matmul"
    tensors = (x, qw, scale)
    if any(t.device != x.device for t in tensors):
        raise ValueError(
            f"{what}: every tensor must lie on one device, got "
            f"{sorted({str(t.device) for t in tensors})}")
    if x.dtype not in _X_CODES or out_dtype not in _X_CODES:
        raise ValueError(f"{what}: x and the output must be float32 or "
                         f"bfloat16, got {x.dtype} -> {out_dtype}")
    if qw.dtype not in _w_codes():
        raise ValueError(f"{what}: the carrier must be int8 or "
                         f"float8_e4m3fn, got {qw.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"{what}: the scale must be float32, got "
                         f"{scale.dtype}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: every tensor must be contiguous")
    m, k = x.shape
    n = qw.shape[1]
    if max(m, k, n) >= 2 ** 31 or -(-m // TILE_M) > 65535:
        raise ValueError(f"{what}: M={m}, K={k}, N={n} beyond the "
                         f"kernel's grid")
    if x.device.type != "cuda":
        raise RuntimeError(
            f"{what}: the kernel runs on CUDA tensors only (the plain "
            f"version takes CPU tensors), got {x.device}")


def _launch(x, qw, scale, out_dtype):
    _check_launch(x, qw, scale, out_dtype)
    m, k = x.shape
    n = qw.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    splits, k_chunk = plan_split_k(m, k, n, x.element_size())
    ws = None if splits == 1 else torch.empty(
        splits, m, n, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.paddle_dequant_matmul(
            x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, k, n, splits, k_chunk,
            _X_CODES[x.dtype], _w_codes()[qw.dtype], _X_CODES[out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"dequant_matmul launch failed: CUDA error {rc} "
            f"({lib.paddle_dequant_cuda_error_string(rc).decode()})")
    graphs.count_launch(dequant_matmul, _COUNT_LOCK, x.device)
    return out


def dequant_matmul(x, qw, scale, *, use_pallas="auto", out_dtype=None):
    """``x [M, K] @ dequant(qw [K, N], scale [N])`` with the dequant
    fused into the matmul (B7).  ``use_pallas`` ('auto', 'always',
    'never'): on CUDA tensors 'auto' and 'always' launch the kernel and
    'never' takes the plain version; tensors on the CPU always take the
    plain version.  There is no shape fallback."""
    if use_pallas not in ("auto", "always", "never"):
        raise ValueError(f"dequant_matmul: use_pallas must be 'auto', "
                         f"'always' or 'never', got {use_pallas!r}")
    _check_args(x, qw, scale)
    out_dtype = out_dtype or x.dtype
    on_cpu = all(t.device.type == "cpu" for t in (x, qw, scale))
    if on_cpu or use_pallas == "never":
        return dequant_matmul_reference(x, qw, scale, out_dtype)
    return _launch(x, qw, scale, out_dtype)


dequant_matmul.launches = 0


def reset_launch_count() -> None:
    """Zero B7's launch counter."""
    with _COUNT_LOCK:
        dequant_matmul.launches = 0


# -- the dequant_matmul op -------------------------------------------------


def _prod(t):
    p = 1
    for v in t:
        p *= int(v)
    return p


@register_lower("dequant_matmul")
def lower_dequant_matmul(ctx, op):
    """The weight-quantized matmul family: ``Y`` is the int8/fp8
    carrier, ``Scale`` the per-output-channel step sizes.  The op
    preserves the ORIGINAL op's semantics (``orig_type`` attr: mul's
    flattening dims, matmul's transpose flags and alpha); the weight is
    dequantized at ``X``'s dtype so AMP-bypassed casts keep their
    numerics.  B7 serves the column-scaled 2-D weight without transposes,
    a batched ``X`` flattened to its rows; everything else dequantizes,
    then multiplies."""
    x = ctx.in1(op, "X")
    qw = ctx.in1(op, "Y")
    scale = ctx.in1(op, "Scale")
    axis = int(op.attr("weight_axis", 1))
    orig = op.attr("orig_type", "matmul_v2")
    use_pallas = op.attr("use_pallas", "auto")
    fused_ok = qw.dim() == 2 and axis == 1
    if orig == "mul":
        xn = int(op.attr("x_num_col_dims", 1))
        yn = int(op.attr("y_num_col_dims", 1))
        xs, ys = x.shape, qw.shape
        x2 = x.reshape(-1, _prod(xs[xn:]))
        out_shape = tuple(xs[:xn]) + tuple(ys[yn:])
        if fused_ok and yn == 1:
            # a row-strided view (e.g. the [CLS] slice) is copied once
            out = dequant_matmul(x2.contiguous(), qw, scale,
                                 use_pallas=use_pallas, out_dtype=x.dtype)
        else:
            w = dequantize_weight(qw, scale, axis, x.dtype)
            out = x2 @ w.reshape(_prod(ys[:yn]), -1)
        ctx.set_out(op, "Out", out.reshape(out_shape))
        return
    trans_x = bool(op.attr("transpose_X", op.attr("trans_x", False)))
    trans_y = bool(op.attr("transpose_Y", op.attr("trans_y", False)))
    alpha = float(op.attr("alpha", 1.0))
    if fused_ok and not trans_x and not trans_y and x.dim() >= 2:
        # a batched x [..., K] against the 2-D weight is one [M, K]
        # matmul over its flattened rows (a dygraph Linear's 3-D input)
        out = dequant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), qw,
                             scale, use_pallas=use_pallas,
                             out_dtype=x.dtype).reshape(
            *x.shape[:-1], qw.shape[1])
    else:
        w = dequantize_weight(qw, scale, axis, x.dtype)
        if trans_x and x.dim() > 1:
            x = x.transpose(-1, -2)
        if trans_y and w.dim() > 1:
            w = w.transpose(-1, -2)
        out = torch.matmul(x, w)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_out(op, "Out", out)


def quant_quality_delta(logits_q, logits_ref):
    """The quantization tax, measured: max-abs-logit delta and greedy
    top-1 agreement of quantized logits vs their full-precision oracle
    over a fixed eval batch.  Returns the report dict AND mirrors it
    onto the monitor (``quant_quality_max_abs_logit_delta_micro``,
    ``quant_quality_top1_agreement_ppm``) so the tax is monitored,
    never assumed."""
    from ..monitor import stat_set

    q = np.asarray(to_numpy(logits_q), dtype=np.float32)
    ref = np.asarray(to_numpy(logits_ref), dtype=np.float32)
    if q.shape != ref.shape:
        raise ValueError(
            f"logit shapes differ: {q.shape} vs {ref.shape}")
    q2 = q.reshape(-1, q.shape[-1])
    r2 = ref.reshape(-1, ref.shape[-1])
    max_abs = float(np.max(np.abs(q2 - r2))) if q2.size else 0.0
    agree = float(np.mean(np.argmax(q2, axis=-1)
                          == np.argmax(r2, axis=-1))) if len(q2) else 1.0
    stat_set("quant_quality_max_abs_logit_delta_micro",
             int(max_abs * 1e6))
    stat_set("quant_quality_top1_agreement_ppm", int(agree * 1e6))
    return {"max_abs_logit_delta": max_abs, "top1_agreement": agree}
