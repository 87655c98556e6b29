"""The rest of the JAX package's ``paddle_tpu/ops/misc_ops.py``: dense
LoD and SelectedRows shims, the transposed convolution variants,
``conv_shift``, ``fsp``, ``data_norm``, ``affine_grid``, ``unpool``,
``center_loss``, ``shuffle_batch``, ``batch_fc``, ``allclose``,
``histogram``, ``bincount``, ``broadcast_to``, ``full_like`` and
``put_along_axis``.  That file's control-flow and TensorArray ops, its
``py_func`` and ``diag`` are the port's ``ops/misc.py``.

Each lowering is held to the JAX lowering where it differs from the
reference C++, as its docstring says.  Gradients come from the generic
``<type>_grad``.  Scatters and gathers follow jax's index rules on the
device (``common.take`` / ``scatter_index``); nothing is read on
the host but ``affine_grid``'s ``OutputShape`` tensor, which makes its
program run eagerly (``executor.capture_reason``'s ``shape_tensor``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import dtypes
from ..framework.lowering import LOWERINGS, register_lower
from .common import promote, scatter_index, take, tdiv


@register_lower("lod_reset")
def _lod_reset(ctx, op):
    """Dense tensors carry no LoD: X passes through (the reference
    rewrites only metadata)."""
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


@register_lower("get_tensor_from_selected_rows", "merge_selected_rows")
def _selected_rows_passthrough(ctx, op):
    """SelectedRows are dense in the port, so both ops are the identity;
    ``merge_selected_rows`` does not sum duplicate rows, as in the JAX
    package."""
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


@register_lower("depthwise_conv2d_transpose")
def _depthwise_conv2d_transpose(ctx, op):
    """``conv2d_transpose``'s lowering, ``groups`` included."""
    LOWERINGS["conv2d_transpose"](ctx, op)


@register_lower("conv3d_transpose")
def _conv3d_transpose(ctx, op):
    """NCDHW transposed 3-D convolution with Filter [in, out, kd, kh,
    kw]: ``F.conv_transpose3d`` with the forward convolution's
    ``paddings`` (the first three), ``strides`` and ``dilations`` and no
    output padding.  The JAX lowering ignores ``padding_algorithm``,
    ``output_size`` and ``data_format``, and so does the port; it has no
    groups (its filter shape fails), so ``groups != 1`` raises."""
    x = ctx.in1(op, "Input")
    w = ctx.in1(op, "Filter")
    groups = int(op.attr("groups", 1) or 1)
    if groups != 1:
        raise NotImplementedError(
            f"conv3d_transpose groups={groups}: only groups=1 is lowered")
    strides = [int(s) for s in op.attr("strides", [1, 1, 1])]
    dilations = [int(d) for d in op.attr("dilations", [1, 1, 1])]
    paddings = [int(p) for p in op.attr("paddings", [0, 0, 0])][:3]
    ctx.set_out(op, "Output", F.conv_transpose3d(
        x, w, stride=strides, padding=paddings, dilation=dilations))


@register_lower("conv_shift")
def _conv_shift(ctx, op):
    """Circular correlation, X [B, D], Y [B, K]: out[b, i] = sum_k
    x[b, (i + k - K // 2) mod D] * y[b, k]."""
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    d, k = x.shape[1], y.shape[1]
    half = k // 2
    dev = x.device
    idx = (torch.arange(d, device=dev)[:, None]
           + torch.arange(-half, k - half, device=dev)[None, :]) % d
    ctx.set_out(op, "Out", torch.einsum("bdk,bk->bd", x[:, idx], y))


@register_lower("fsp")
def _fsp(ctx, op):
    """FSP matrix for distillation: [N, Cx, H, W] x [N, Cy, H, W] ->
    [N, Cx, Cy], the products of channel maps summed over H * W and
    divided by H * W."""
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    n, cx, h, w = x.shape
    out = torch.bmm(x.reshape(n, cx, h * w),
                    y.reshape(n, y.shape[1], h * w).transpose(1, 2))
    ctx.set_out(op, "Out", tdiv(out, h * w))


@register_lower("data_norm")
def _data_norm(ctx, op):
    """The JAX lowering's formula: mean = BatchSum / BatchSize, scale =
    sqrt(BatchSize / (BatchSquareSum - BatchSum * mean + epsilon)), Y =
    (X - mean) * scale; ``Means`` and ``Scales`` broadcast to X's
    shape."""
    x = ctx.in1(op, "X")
    bsize = ctx.in1(op, "BatchSize")
    bsum = ctx.in1(op, "BatchSum")
    bsq = ctx.in1(op, "BatchSquareSum")
    eps = float(op.attr("epsilon", 1e-4))
    mean = bsum / bsize
    scale = torch.sqrt(bsize / (bsq - bsum * mean + eps))
    ctx.set_out(op, "Y", (x - mean) * scale)
    ctx.set_out(op, "Means", torch.broadcast_to(mean, x.shape).contiguous())
    ctx.set_out(op, "Scales",
                torch.broadcast_to(scale, x.shape).contiguous())


@register_lower("affine_grid")
def _affine_grid(ctx, op):
    """Theta [N, 2, 3] -> sampling grid [N, H, W, 2] over ``linspace(-1,
    1)`` in each axis, shrunk by (size - 1) / size for ``align_corners``
    False.  The shape is the ``output_shape`` attr, or the
    ``OutputShape`` tensor, which is read on the host (a program holding
    one runs eagerly)."""
    theta = ctx.in1(op, "Theta")
    shape = op.attr("output_shape", [])
    osize = ctx.in1(op, "OutputShape")
    if osize is not None:
        shape = [int(v) for v in osize.reshape(-1).tolist()]
    _n, _c, h, w = (int(s) for s in shape)
    dev, dt = theta.device, theta.dtype
    ys = torch.linspace(-1.0, 1.0, h, dtype=dt, device=dev)
    xs = torch.linspace(-1.0, 1.0, w, dtype=dt, device=dev)
    if not bool(op.attr("align_corners", True)):
        ys = tdiv(ys * (h - 1), h)
        xs = tdiv(xs * (w - 1), w)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")           # [H, W]
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    out = torch.einsum("hwk,njk->nhwj", base, theta)
    ctx.set_out(op, "Output", out)


@register_lower("unpool")
def _unpool(ctx, op):
    """Max unpooling by stored flat indices: X [N, C, H, W] added into a
    zero [N, C, OH * OW] at ``Indices``, the output size from ``ksize``,
    ``strides`` and ``paddings`` alone.  Duplicates add; an index out of
    range is dropped (a negative one wraps once), as in jax's
    scatter."""
    x = ctx.in1(op, "X")
    idx = ctx.in1(op, "Indices")
    ksize = [int(k) for k in op.attr("ksize", [2, 2])]
    strides = [int(s) for s in op.attr("strides", [2, 2])]
    paddings = [int(p) for p in op.attr("paddings", [0, 0])]
    n, c, h, w = x.shape
    oh = (h - 1) * strides[0] - 2 * paddings[0] + ksize[0]
    ow = (w - 1) * strides[1] - 2 * paddings[1] + ksize[1]
    where, valid = scatter_index(idx.reshape(n, c, -1), oh * ow)
    vals = x.reshape(n, c, -1)
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    out = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    ctx.set_out(op, "Out", out.scatter_add(2, where, vals)
                .reshape(n, c, oh, ow))


@register_lower("center_loss")
def _center_loss(ctx, op):
    """Loss = 0.5 * ||X - Centers[label]||^2 per row and, with
    ``need_update``, CentersOut = Centers + alpha * (sum of the diffs of
    each class) / (count + 1), alpha the ``CenterUpdateRate`` input (0.5
    without it).  The labels gather as jax gathers (clamped, the gradient
    of an out-of-range read dropped) and scatter as it scatters (out of
    range dropped)."""
    x = ctx.in1(op, "X")
    label = ctx.in1(op, "Label").reshape(-1)
    centers = ctx.in1(op, "Centers")
    update_rate = ctx.in1(op, "CenterUpdateRate")
    n_classes = centers.shape[0]
    diff = x - take(centers, label)
    loss = 0.5 * torch.sum(torch.square(diff), dim=1, keepdim=True)
    ctx.set_out(op, "Loss", loss)
    ctx.set_out(op, "SampleCenterDiff", diff)
    if not bool(op.attr("need_update", True)):
        ctx.set_out(op, "CentersOut", centers)
        return
    idx, valid = scatter_index(label, n_classes)
    ones = valid.to(x.dtype)
    cnt = torch.zeros((n_classes,), dtype=x.dtype,
                      device=x.device).index_add(0, idx, ones)
    upd = torch.zeros_like(centers).index_add(
        0, idx, torch.where(valid[:, None], diff, torch.zeros_like(diff)))
    alpha = update_rate.reshape(()) if update_rate is not None else 0.5
    ctx.set_out(op, "CentersOut",
                centers + alpha * upd / (cnt[:, None] + 1.0))


@register_lower("shuffle_batch")
def _shuffle_batch(ctx, op):
    """X's rows in a random order drawn from the program's generator
    (``seed`` is not read, as in the JAX package); ``ShuffleIdx`` is the
    permutation, int32.  Like the JAX package, the port has no
    ``shuffle_batch_grad``: the generic gradient cannot replay a draw."""
    x = ctx.in1(op, "X")
    perm = torch.randperm(x.shape[0], generator=ctx.next_generator(),
                          device=x.device)
    ctx.set_out(op, "Out", x[perm])
    ctx.set_out(op, "ShuffleIdx", perm.to(torch.int32))


@register_lower("batch_fc")
def _batch_fc(ctx, op):
    """Input [B, N, D] @ W [B, D, O] (+ Bias [B, 1, O]) per slot."""
    x = ctx.in1(op, "Input")
    w = ctx.in1(op, "W")
    bias = ctx.in1(op, "Bias")
    out = torch.bmm(x, w)
    ctx.set_out(op, "Out", out + bias if bias is not None else out)


@register_lower("allclose")
def _allclose(ctx, op):
    """``isclose(...).all()``: a 0-d bool on the device (never
    ``torch.allclose``, whose Python bool is a host read).  ``rtol`` and
    ``atol`` are the attrs (1e-5 / 1e-8 when unset or 0)."""
    x, y = promote(ctx.in1(op, "Input"), ctx.in1(op, "Other"))
    rtol = float(op.attr("rtol", 1e-5) or 1e-5)
    atol = float(op.attr("atol", 1e-8) or 1e-8)
    ctx.set_out(op, "Out", torch.isclose(
        x, y, rtol=rtol, atol=atol,
        equal_nan=bool(op.attr("equal_nan", False))).all())


def _hist_edges(lo, hi, bins, device):
    """``jnp.linspace(lo, hi, bins + 1)`` in float32 as XLA compiles it:
    step = iota * float32(1 / bins), edge = lo * (1 - step) + iota * (hi
    * float32(1 / bins)), the last edge ``hi`` (for [0, 1] in 10 bins the
    edge under 1 is 0.90000004).  XLA's CPU code may fuse a product and
    the sum into one rounding, so an edge of a wide range can differ from
    the JAX package's by one float32 step."""
    f32 = np.float32
    lo, hi = f32(lo), f32(hi)
    if lo == hi:      # histogram_bin_edges widens an empty range
        lo, hi = f32(lo - f32(0.5)), f32(hi + f32(0.5))
    r = f32(1) / f32(bins)
    it = torch.arange(bins, dtype=torch.float32, device=device)
    edges = float(lo) * (1 - it * float(r)) + it * float(f32(hi * r))
    return torch.cat([edges, torch.full((1,), float(hi), device=device)])


@register_lower("histogram")
def _histogram(ctx, op):
    """int32 counts of X over ``bins`` equal bins of [min, max], as
    ``jnp.histogram``: the edges in float32 (``_hist_edges``), a value's
    bin ``searchsorted(edges, x, right=True)``, a value on the top edge in
    the last bin, values outside the range (and NaN) not counted.  With
    min == max == 0 (the reference's data range) it raises, as the JAX
    lowering does."""
    x = ctx.in1(op, "X")
    bins = int(op.attr("bins", 100))
    lo = float(op.attr("min", 0))
    hi = float(op.attr("max", 0))
    if lo == 0 and hi == 0:
        raise NotImplementedError(
            "histogram needs explicit min/max attrs (a data-dependent range "
            "is not static)")
    vals = x.reshape(-1).float()
    edges = _hist_edges(lo, hi, bins, x.device)
    idx = torch.searchsorted(edges, vals, right=True)
    idx = torch.where(vals == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.zeros((bins + 2,), dtype=torch.int64, device=x.device)
    counts = counts.scatter_add(0, idx, torch.ones_like(idx))
    ctx.set_out(op, "Out", counts[1:bins + 1].to(torch.int32))


@register_lower("bincount")
def _bincount(ctx, op):
    """Counts (or summed ``Weights``) of X's values over ``minlength``
    bins, as ``jnp.bincount(length=minlength)``: a negative value counts
    in bin 0, one at or past ``minlength`` is dropped.  A scatter-add on
    the device, never ``torch.bincount`` (which refuses negatives and
    sizes its output by the data).  Counts are int64 (jax's default int,
    int32 with x64 off); weighted sums keep the weights' type.
    ``minlength <= 0`` raises, as the JAX lowering does."""
    x = ctx.in1(op, "X")
    w = ctx.in1(op, "Weights")
    minlength = int(op.attr("minlength", 0))
    if minlength <= 0:
        raise NotImplementedError(
            "bincount needs minlength > 0 (a static output shape)")
    idx = x.reshape(-1).long().clamp_min(0)
    valid = idx < minlength
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    vals = valid.long() if w is None else torch.where(
        valid, w.reshape(-1), torch.zeros_like(w.reshape(-1)))
    out = torch.zeros((minlength,), dtype=vals.dtype, device=x.device)
    ctx.set_out(op, "Out", out.scatter_add(0, idx, vals))


@register_lower("broadcast_to")
def _broadcast_to(ctx, op):
    """X broadcast to the ``shape`` attr, a -1 among its last X.ndim
    entries keeping X's size there; a contiguous tensor."""
    x = ctx.in1(op, "X")
    shape = [int(s) for s in op.attr("shape", [])]
    lead = len(shape) - x.dim()
    shape = [x.shape[i - lead] if s == -1 and i >= lead else s
             for i, s in enumerate(shape)]
    ctx.set_out(op, "Out", torch.broadcast_to(x, shape).contiguous())


@register_lower("full_like")
def _full_like(ctx, op):
    """A tensor of X's shape filled with ``value``, of the ``dtype`` attr
    (X's type when it is -1 or unset)."""
    x = ctx.in1(op, "X")
    dtype = op.attr("dtype", -1)
    dt = x.dtype if dtype in (-1, None) else dtypes.to_torch(dtype)
    ctx.set_out(op, "Out", torch.full(tuple(x.shape), op.attr("value", 0.0),
                                      dtype=dt, device=x.device))


@register_lower("put_along_axis")
def _put_along_axis(ctx, op):
    """Input with Value put at Index along ``Axis`` (the other axes at
    Index's own positions), by ``Reduce``: ``assign`` (which of several
    duplicates wins is unspecified, as in jax), ``add`` or ``mul``
    (``multiply``; ``scatter_reduce`` "prod" with the input included).
    An index out of range is dropped and a negative one wraps once, as in
    jax's scatter: it is sent to one extra slot past the axis, cut off
    after."""
    x = ctx.in1(op, "Input")
    idx = ctx.in1(op, "Index")
    val = ctx.in1(op, "Value")
    axis = int(op.attr("Axis", 0))
    axis = axis + x.dim() if axis < 0 else axis
    reduce = op.attr("Reduce", "assign")
    n = x.shape[axis]
    val = torch.broadcast_to(val, idx.shape).to(x.dtype)
    where, valid = scatter_index(idx, n)
    where = torch.where(valid, where, torch.full_like(where, n))
    pad = list(x.shape)
    pad[axis] = 1
    xe = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)],
                   dim=axis)
    if reduce == "add":
        out = xe.scatter_add(axis, where, val)
    elif reduce in ("multiply", "mul"):
        out = xe.scatter_reduce(axis, where, val, "prod", include_self=True)
    else:
        out = xe.scatter(axis, where, val)
    ctx.set_out(op, "Result", out.narrow(axis, 0, n))
