"""Tensor manipulation ops: reshape / transpose / flatten / squeeze /
unsqueeze, concat / split / stack / unstack, slicing, gather and scatter,
tile and expand, top-k / arg-max / argsort / where, one-hot, pad,
tril / triu, ``diag``, ``size``, cumsum, flip, roll, meshgrid, cast, and
activation recompute's ``recompute_barrier``.

Counterpart of ``paddle_tpu/ops/tensor_ops.py`` (``where_index``, the
JAX package's ``tail_ops.py``, included: ``nonzero``'s fixed-size form,
coordinates first and -1 rows after, with ``Count``).  Reference parity:
operators/reshape_op.cc, transpose_op.cc, concat_op.cc, split_op.cc,
slice_op.cc, gather_op.cc, scatter_op.cc, squeeze_op.cc,
unsqueeze_op.cc, stack_op.cc, tile/expand ops, cast_op.cc, top_k_op.cc,
arg_max/min, where/select ops, pad ops, one_hot.

Where the JAX rule's result differs from the reference's, the port
follows the reference and says so: ``arg_min`` honours ``flatten`` (the
JAX rule ignores it).  ``top_k`` / ``argsort`` indices are int32, as the
JAX rules give them; ``arg_max`` / ``arg_min`` take their ``dtype``
attribute (int64 stays int64).  A shape, axis or count given as a tensor
is read on the host, as the JAX rules read it at trace time.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower
from .common import attr_dtype, promote


def _xshape(ctx, op, x):
    if op.outputs.get("XShape"):
        # the reference's XShape carries the input shape behind a 0 dim
        ctx.set_out(op, "XShape", x.new_zeros((0,) + tuple(x.shape)))


def _host_int(ctx, name) -> int:
    return int(ctx.get(name).reshape(-1)[0].item())


def _resolve_reshape(x, shape):
    out = [int(s) for s in shape]
    for i, s in enumerate(out):
        if s == 0:  # 0 copies the input's dim
            out[i] = x.shape[i]
    return out


@register_lower("reshape", "reshape2")
def _reshape(ctx, op):
    x = ctx.in1(op, "X")
    shape = op.attr("shape", [])
    st = op.inputs.get("ShapeTensor") or op.inputs.get("Shape")
    if st:
        # the JAX package's rule, with the values read on the host (a
        # program holding one runs eagerly, capture_reason "shape_tensor"):
        # one tensor of several elements is the shape, scalars are its
        # dims, a mix leaves the attr
        vals = [ctx.get(n).reshape(-1) for n in st]
        if len(vals) == 1 and vals[0].numel() > 1:
            shape = [int(v) for v in vals[0].tolist()]
        elif all(v.numel() == 1 for v in vals):
            shape = [int(v.item()) for v in vals]
    ctx.set_out(op, "Out", x.reshape(_resolve_reshape(x, shape)))
    _xshape(ctx, op, x)


@register_lower("reshape2_grad")
def _reshape2_grad(ctx, op):
    # XShape carries the input's shape behind a 0 dim (``_xshape``)
    ctx.set_out(op, "X@GRAD", ctx.in1(op, "Out@GRAD").reshape(
        tuple(ctx.in1(op, "XShape").shape)[1:]))


@register_lower("transpose", "transpose2")
def _transpose(ctx, op):
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", x.permute([int(a) for a in op.attr("axis", [])]))
    _xshape(ctx, op, x)


@register_lower("transpose2_grad")
def _transpose2_grad(ctx, op):
    dy = ctx.in1(op, "Out@GRAD")
    axis = [int(a) for a in op.attr("axis", [])]
    inv = sorted(range(len(axis)), key=axis.__getitem__)  # argsort
    ctx.set_out(op, "X@GRAD", dy.permute(inv))


@register_lower("slice")
def _slice(ctx, op):
    x = ctx.in1(op, "Input")
    axes = [int(a) for a in op.attr("axes", [])]
    starts = [int(s) for s in op.attr("starts", [])]
    ends = [int(e) for e in op.attr("ends", [])]
    decrease = [int(d) for d in op.attr("decrease_axis", []) or []]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    squeeze = tuple(d for d in decrease if out.shape[d] == 1)
    if squeeze:
        out = out.squeeze(squeeze)
    ctx.set_out(op, "Out", out)


@register_lower("gather")
def _gather(ctx, op):
    x = ctx.in1(op, "X")
    index = ctx.in1(op, "Index")
    axis = int(op.attr("axis", 0))
    if index.dim() == 2 and index.shape[1] == 1:
        index = index.squeeze(-1)
    axis %= x.dim()
    out = torch.index_select(x, axis, index.reshape(-1))
    ctx.set_out(op, "Out", out.reshape(
        tuple(x.shape[:axis]) + tuple(index.shape) + tuple(x.shape[axis + 1:])))


@register_lower("cast")
def _cast(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X").to(attr_dtype(op, "out_dtype")))


@register_lower("flatten", "flatten2")
def _flatten(ctx, op):
    x = ctx.in1(op, "X")
    axis = int(op.attr("axis", 1))
    lead = int(np.prod(x.shape[:axis]))
    ctx.set_out(op, "Out", x.reshape(lead, -1))
    _xshape(ctx, op, x)


@register_lower("flatten_contiguous_range")
def _flatten_range(ctx, op):
    x = ctx.in1(op, "X")
    nd = max(x.dim(), 1)
    start = int(op.attr("start_axis", 1)) % nd
    stop = int(op.attr("stop_axis", -1)) % nd
    shape = list(x.shape[:start]) + [-1] + list(x.shape[stop + 1:])
    ctx.set_out(op, "Out", x.reshape(shape))
    _xshape(ctx, op, x)


@register_lower("squeeze", "squeeze2")
def _squeeze(ctx, op):
    x = ctx.in1(op, "X")
    axes = [int(a) % x.dim() for a in op.attr("axes", [])]
    if not axes:
        axes = [i for i, s in enumerate(x.shape) if s == 1]
    axes = tuple(a for a in axes if x.shape[a] == 1)
    ctx.set_out(op, "Out", x.squeeze(axes) if axes else x)
    _xshape(ctx, op, x)


@register_lower("unsqueeze", "unsqueeze2")
def _unsqueeze(ctx, op):
    x = ctx.in1(op, "X")
    out = x
    for a in sorted(int(a) for a in op.attr("axes", [])):
        out = out.unsqueeze(a if a >= 0 else a + out.dim() + 1)
    ctx.set_out(op, "Out", out)
    _xshape(ctx, op, x)


@register_lower("concat")
def _concat(ctx, op):
    xs = ctx.in_list(op, "X")
    at = op.inputs.get("AxisTensor")
    axis = _host_int(ctx, at[0]) if at else int(op.attr("axis", 0))
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    ctx.set_out(op, "Out", torch.cat([x.to(dt) for x in xs], dim=axis))


@register_lower("split")
def _split(ctx, op):
    x = ctx.in1(op, "X")
    axis = int(op.attr("axis", 0))
    sections = [int(s) for s in op.attr("sections", []) or []]
    outs = op.outputs.get("Out", [])
    if sections:
        known = sum(s for s in sections if s > 0)
        sections = [s if s > 0 else x.shape[axis] - known for s in sections]
        parts = torch.split(x, sections, dim=axis)
    else:
        num = int(op.attr("num", 0)) or len(outs)
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    for name, p in zip(outs, parts):
        ctx.set(name, p)


@register_lower("stack")
def _stack(ctx, op):
    ctx.set_out(op, "Y", torch.stack(ctx.in_list(op, "X"),
                                     dim=int(op.attr("axis", 0))))


@register_lower("unstack")
def _unstack(ctx, op):
    parts = torch.unbind(ctx.in1(op, "X"), dim=int(op.attr("axis", 0)))
    for name, p in zip(op.outputs.get("Y", []), parts):
        ctx.set(name, p)


@register_lower("strided_slice")
def _strided_slice(ctx, op):
    """Python slicing per axis (a negative stride included, which torch's
    slicing lacks: those axes gather their indices)."""
    out = ctx.in1(op, "Input")
    for a, s, e, st in zip(*(
            [int(v) for v in op.attr(k, [])]
            for k in ("axes", "starts", "ends", "strides"))):
        if st > 0:
            idx = [slice(None)] * out.dim()
            idx[a] = slice(s, e, st)
            out = out[tuple(idx)]
        else:
            keep = range(*slice(s, e, st).indices(out.shape[a]))
            out = torch.index_select(out, a, torch.tensor(
                list(keep), dtype=torch.long, device=out.device))
    ctx.set_out(op, "Out", out)


def _coords(index):
    index = index.long()
    return tuple(index[..., i] for i in range(index.shape[-1]))


@register_lower("gather_nd")
def _gather_nd(ctx, op):
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", x[_coords(ctx.in1(op, "Index"))])


@register_lower("scatter")
def _scatter(ctx, op):
    x = ctx.in1(op, "X")
    ids = ctx.in1(op, "Ids")
    if ids.dim() == 2 and ids.shape[1] == 1:
        ids = ids.squeeze(-1)
    upd = ctx.in1(op, "Updates").to(x.dtype)
    ctx.set_out(op, "Out", x.index_put(
        (ids.long(),), upd, accumulate=not bool(op.attr("overwrite", True))))


@register_lower("scatter_nd_add")
def _scatter_nd_add(ctx, op):
    x = ctx.in1(op, "X")
    upd = ctx.in1(op, "Updates").to(x.dtype)
    ctx.set_out(op, "Out", x.index_put(_coords(ctx.in1(op, "Index")), upd,
                                       accumulate=True))


@register_lower("index_select")
def _index_select(ctx, op):
    x = ctx.in1(op, "X")
    index = ctx.in1(op, "Index")
    axis = int(op.attr("dim", 0)) % x.dim()
    out = torch.index_select(x, axis, index.reshape(-1).long())
    ctx.set_out(op, "Out", out.reshape(
        tuple(x.shape[:axis]) + tuple(index.shape) + tuple(x.shape[axis + 1:])))


@register_lower("expand", "tile")
def _expand(ctx, op):
    x = ctx.in1(op, "X")
    times = [int(t) for t in (op.attr("expand_times", None)
                              or op.attr("repeat_times", []))]
    if len(times) < x.dim():
        times = [1] * (x.dim() - len(times)) + times
    ctx.set_out(op, "Out", x.repeat(times))


@register_lower("expand_as", "expand_as_v2")
def _expand_as(ctx, op):
    x = ctx.in1(op, "X")
    target = op.inputs.get("Y") or op.inputs.get("target_tensor")
    shape = tuple(ctx.get(target[0]).shape) if target \
        else tuple(op.attr("target_shape", []))
    ctx.set_out(op, "Out", torch.broadcast_to(x, shape))


@register_lower("expand_v2")
def _expand_v2(ctx, op):
    x = ctx.in1(op, "X")
    shape = [int(s) for s in op.attr("shape", [])]
    if len(shape) > x.dim():
        x = x.reshape((1,) * (len(shape) - x.dim()) + tuple(x.shape))
    shape = [x.shape[i] if s == -1 else s for i, s in enumerate(shape)]
    ctx.set_out(op, "Out", torch.broadcast_to(x, shape))


@register_lower("top_k", "top_k_v2")
def _top_k(ctx, op):
    x = ctx.in1(op, "X")
    kt = op.inputs.get("K")
    k = _host_int(ctx, kt[0]) if kt else int(op.attr("k", 1))
    vals, idx = torch.topk(x, k, dim=int(op.attr("axis", -1)),
                           largest=bool(op.attr("largest", True)))
    ctx.set_out(op, "Out", vals)
    ctx.set_out(op, "Indices", idx.int())


def _arg(fn):
    def lower(ctx, op):
        x = ctx.in1(op, "X")
        axis = int(op.attr("axis", -1))
        flatten = bool(op.attr("flatten", False))
        if flatten:
            x, axis = x.reshape(-1), 0
        out = fn(x, dim=axis, keepdim=bool(op.attr("keepdims", False))
                 and not flatten)
        ctx.set_out(op, "Out", out.to(attr_dtype(op, "dtype", "int64")))

    return lower


register_lower("arg_max")(_arg(torch.argmax))
register_lower("arg_min")(_arg(torch.argmin))


@register_lower("argsort")
def _argsort(ctx, op):
    x = ctx.in1(op, "X")
    out, idx = torch.sort(x, dim=int(op.attr("axis", -1)), stable=True,
                          descending=bool(op.attr("descending", False)))
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "Indices", idx.int())


@register_lower("where")
def _where(ctx, op):
    x, y = promote(ctx.in1(op, "X"), ctx.in1(op, "Y"))
    ctx.set_out(op, "Out", torch.where(ctx.in1(op, "Condition").bool(), x, y))


@register_lower("where_index")
def _where_index(ctx, op):
    """nonzero: Out is [numel, rank] int32, valid coordinates first
    (row-major order), tail rows -1, plus Count."""
    cond = ctx.in1(op, "Condition")
    flat = cond.reshape(-1).bool()
    order = torch.argsort((~flat).int(), stable=True)
    coords, rest = [], order
    for size in reversed(cond.shape):
        coords.append(rest % size)
        rest = torch.div(rest, size, rounding_mode="floor")
    coords = torch.stack(coords[::-1], dim=1).int() if coords \
        else order.new_zeros((order.numel(), 0), dtype=torch.int32)
    out = torch.where(flat[order][:, None], coords,
                      torch.full((), -1, dtype=torch.int32,
                                 device=cond.device))
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "Count", flat.sum().int())


@register_lower("one_hot", "one_hot_v2")
def _one_hot(ctx, op):
    """float32 rows; an index outside [0, depth) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    x = ctx.in1(op, "X")
    dt = op.inputs.get("depth_tensor")
    depth = _host_int(ctx, dt[0]) if dt else int(op.attr("depth", -1))
    if op.type == "one_hot" and x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    classes = torch.arange(depth, device=x.device)
    ctx.set_out(op, "Out", (x.unsqueeze(-1) == classes).float())


@register_lower("shape")
def _shape(ctx, op):
    x = ctx.in1(op, "Input")
    ctx.set_out(op, "Out", torch.tensor(list(x.shape), dtype=torch.int32,
                                        device=x.device))


@register_lower("size")
def _size(ctx, op):
    """The element count, int64 (the JAX package's x64-off int32)."""
    x = ctx.in1(op, "Input")
    ctx.set_out(op, "Out", torch.tensor(x.numel(), dtype=torch.int64,
                                        device=x.device))


@register_lower("diag", "diag_v2")
def _diag(ctx, op):
    """A vector to a matrix with it on diagonal ``offset`` (the rest
    ``padding_value``), or a matrix's diagonal ``offset``."""
    x = ctx.in1(op, "X")
    offset = int(op.attr("offset", 0))
    pad = float(op.attr("padding_value", 0.0))
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if pad:
            mask = torch.diag(torch.ones_like(x), offset)
            out = out + pad * (1 - mask)
    else:
        out = torch.diagonal(x, offset)
    ctx.set_out(op, "Out", out)


def _pad_list(pairs):
    """((lo, hi) per dim, first dim first) as F.pad's last-dim-first list."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


@register_lower("pad")
def _pad(ctx, op):
    x = ctx.in1(op, "X")
    p = [int(v) for v in op.attr("paddings", [])]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    ctx.set_out(op, "Out", F.pad(x, _pad_list(pairs),
                                 value=float(op.attr("pad_value", 0.0))))


@register_lower("pad2d", "pad3d")
def _pad2d(ctx, op):
    """Spatial padding, ``paddings`` last spatial dim first per pair
    (reference pad2d/pad3d); modes constant / reflect / replicate (edge)
    / circular."""
    x = ctx.in1(op, "X")
    p = [int(v) for v in op.attr("paddings", [])]
    nspatial = x.dim() - 2
    spatial = list(reversed([(p[2 * i], p[2 * i + 1])
                             for i in range(len(p) // 2)]))[:nspatial]
    spatial = [(0, 0)] * (nspatial - len(spatial)) + spatial
    mode = {"edge": "replicate"}.get(op.attr("mode", "constant"),
                                      op.attr("mode", "constant"))
    nhwc = (op.attr("data_format", "NCHW") or "NCHW").endswith("C")
    if nhwc:
        x = x.movedim(-1, 1)
    if mode == "constant":
        out = F.pad(x, _pad_list(spatial), value=float(
            op.attr("value", op.attr("pad_value", 0.0))))
    else:
        out = F.pad(x, _pad_list(spatial), mode=mode)
    ctx.set_out(op, "Out", out.movedim(1, -1) if nhwc else out)


@register_lower("tril_triu")
def _tril_triu(ctx, op):
    x = ctx.in1(op, "X")
    diag = int(op.attr("diagonal", 0))
    ctx.set_out(op, "Out", torch.tril(x, diag) if bool(op.attr("lower", True))
                else torch.triu(x, diag))


@register_lower("cumsum")
def _cumsum(ctx, op):
    x = ctx.in1(op, "X")
    axis = int(op.attr("axis", -1))
    if bool(op.attr("flatten", False)):
        x, axis = x.reshape(-1), 0
    if bool(op.attr("reverse", False)):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if bool(op.attr("exclusive", False)):
        out = out - x
    if not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool):
        out = out.to(x.dtype)   # jnp.cumsum keeps integer types
    ctx.set_out(op, "Out", out)


@register_lower("take_along_axis")
def _take_along_axis(ctx, op):
    ctx.set_out(op, "Result", torch.take_along_dim(
        ctx.in1(op, "Input"), ctx.in1(op, "Index").long(),
        dim=int(op.attr("Axis", 0))))


@register_lower("meshgrid")
def _meshgrid(ctx, op):
    outs = torch.meshgrid(*ctx.in_list(op, "X"), indexing="ij")
    for name, o in zip(op.outputs.get("Out", []), outs):
        ctx.set(name, o)


@register_lower("flip")
def _flip(ctx, op):
    ctx.set_out(op, "Out", torch.flip(
        ctx.in1(op, "X"), tuple(int(a) for a in op.attr("axis", []))))


@register_lower("roll")
def _roll(ctx, op):
    x = ctx.in1(op, "X")
    shifts = [int(s) for s in op.attr("shifts", [])]
    axes = op.attr("axis", []) or None
    if axes is not None:
        out = torch.roll(x, shifts, [int(a) for a in axes])
    else:
        out = torch.roll(x.reshape(-1), shifts[0]).reshape(x.shape)
    ctx.set_out(op, "Out", out)


@register_lower("recompute_barrier")
def _recompute_barrier(ctx, op):
    """Activation recompute's fence (``framework/backward.py``
    ``_emit_recompute_segments``): the identity.  The JAX rule wraps it
    in ``lax.optimization_barrier`` so that XLA cannot merge the
    re-emitted forward with the original; the port runs ops one at a
    time and merges nothing, so the identity is the whole rule."""
    ctx.set_out(op, "Out", ctx.in1(op, "X"))
