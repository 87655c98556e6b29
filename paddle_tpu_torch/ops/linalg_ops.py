"""Linear algebra and tensor math: the lowerings of the JAX package's
``linalg_ops.py`` (``cholesky``, ``inverse``, ``addmm``, ``mv``,
``kron``, ``cross``, ``dist``, ``trace``, ``logsumexp``, ``norm``,
``multiplex``, ``unbind``, ``minus``, ``partial_sum``,
``partial_concat``, ``segment_pool``), the norms (``p_norm``,
``frobenius_norm``, from its ``misc.py``) and the beam-search ancestry
walk (``backtrack_beams``, the ``gather_tree`` op).

Counterpart of ``paddle_tpu/ops/linalg_ops.py`` and of the norm rules of
``paddle_tpu/ops/misc.py``.  Gradients come from the generic
``<type>_grad`` (autograd over the replayed forward), as the JAX
package's come from ``jax.vjp``; where the reduction picks among ties
(``dist`` at p = +-inf, ``segment_pool`` MAX / MIN) both split the
gradient evenly.  Reference parity: cholesky_op.cc, inverse_op.cc,
addmm_op.cc, mv_op.cc, kron_op.cc, cross_op.cc (``dim`` INT_MIN: the
first axis of extent 3), dist_op.cc, trace_op.cc, logsumexp_op.cc
(``axis`` defaults to [0], an empty list or ``reduce_all`` is every
axis), norm_op.cc (``Out`` = X / sqrt(sum X^2 + eps), ``Norm`` kept),
multiplex_op.cc, unbind_op.cc, minus_op.cc, partial_sum_op.cc,
partial_concat_op.cc, segment_pool_op.cc (N segments for N rows; an
empty segment holds 0 under SUM and MEAN, -inf under MAX and +inf
under MIN, as ``jax.ops.segment_max`` / ``segment_min`` give),
gather_tree_op.cc, p_norm_op.cc (``porder`` +-inf: the largest /
smallest magnitude; ``asvector`` or no axis: over every element),
frobenius_norm_op.cc.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower

INT_MIN = -2147483648


# the ``_ex`` forms raise nothing.  cholesky_ex stops at the first
# non-positive pivot and leaves a partial, finite factor; the factor of
# each such matrix is scaled by NaN (its gradient too) on the device, by
# ``info``, and its strict upper triangle kept 0, as jnp.linalg.cholesky
# gives.  No flag is read on the host, so a step holding it is captured.
# A singular matrix's inverse is the LU solve's inf / NaN, as
# jnp.linalg.inv's; the batched LU synchronizes inside the library, and a
# program holding it runs eagerly (executor.HOST_SYNC_OPS)
@register_lower("cholesky")
def _cholesky(ctx, op):
    low, info = torch.linalg.cholesky_ex(ctx.in1(op, "X"))
    bad = torch.where(info == 0, 1.0, float("nan")).to(low.dtype)
    low = torch.tril(low * bad[..., None, None])
    ctx.set_out(op, "Out", low.transpose(-1, -2)
                if bool(op.attr("upper", False)) else low)


@register_lower("inverse")
def _inverse(ctx, op):
    ctx.set_out(op, "Output",
                torch.linalg.inv_ex(ctx.in1(op, "Input")).inverse)


@register_lower("addmm")
def _addmm(ctx, op):
    ctx.set_out(op, "Out", torch.addmm(
        ctx.in1(op, "Input"), ctx.in1(op, "X"), ctx.in1(op, "Y"),
        beta=float(op.attr("Beta", 1.0)), alpha=float(op.attr("Alpha", 1.0))))


@register_lower("mv")
def _mv(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X") @ ctx.in1(op, "Vec"))


@register_lower("kron")
def _kron(ctx, op):
    ctx.set_out(op, "Out", torch.kron(ctx.in1(op, "X"), ctx.in1(op, "Y")))


@register_lower("cross")
def _cross(ctx, op):
    x = ctx.in1(op, "X")
    dim = op.attr("dim", None)
    if dim is None or int(dim) == INT_MIN:
        dim = next(i for i, s in enumerate(x.shape) if s == 3)
    ctx.set_out(op, "Out", torch.linalg.cross(x, ctx.in1(op, "Y"),
                                              dim=int(dim)))


@register_lower("dist")
def _dist(ctx, op):
    x = ctx.in1(op, "X")
    p = float(op.attr("p", 2.0))
    d = torch.abs(x - ctx.in1(op, "Y"))
    if p == float("inf"):
        out = torch.amax(d)
    elif p == float("-inf"):
        out = torch.amin(d)
    elif p == 0:
        out = torch.sum((d != 0).to(x.dtype))
    else:
        out = torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)
    ctx.set_out(op, "Out", out)


@register_lower("trace")
def _trace(ctx, op):
    ctx.set_out(op, "Out", torch.diagonal(
        ctx.in1(op, "Input"), offset=int(op.attr("offset", 0)),
        dim1=int(op.attr("axis1", 0)), dim2=int(op.attr("axis2", 1))
    ).sum(-1))


@register_lower("logsumexp")
def _logsumexp(ctx, op):
    x = ctx.in1(op, "X")
    axis = op.attr("axis", [0])
    if bool(op.attr("reduce_all", False)) or not axis:
        dims = tuple(range(x.dim()))
    else:
        dims = tuple(int(a) for a in axis)
    ctx.set_out(op, "Out", torch.logsumexp(
        x, dim=dims, keepdim=bool(op.attr("keepdim", False))))


@register_lower("norm")
def _norm(ctx, op):
    x = ctx.in1(op, "X")
    n = torch.sqrt(torch.sum(torch.square(x), dim=int(op.attr("axis", -1)),
                             keepdim=True) + float(op.attr("epsilon", 1e-10)))
    ctx.set_out(op, "Out", x / n)
    ctx.set_out(op, "Norm", n)


@register_lower("multiplex")
def _multiplex(ctx, op):
    stacked = torch.stack(ctx.in_list(op, "X"))          # [K, N, D]
    idx = ctx.in1(op, "Ids").reshape(-1).long()         # [N]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    ctx.set_out(op, "Out", stacked[idx, rows])


@register_lower("unbind")
def _unbind(ctx, op):
    outs = torch.unbind(ctx.in1(op, "X"), dim=int(op.attr("axis", 0)))
    for name, val in zip(op.outputs.get("Out", []), outs):
        ctx.set(name, val)


@register_lower("minus")
def _minus(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X") - ctx.in1(op, "Y"))


def _column_range(op):
    start = int(op.attr("start_index", 0))
    length = int(op.attr("length", -1))
    return slice(start, None if length < 0 else start + length)


@register_lower("partial_sum")
def _partial_sum(ctx, op):
    cols = _column_range(op)
    ctx.set_out(op, "Out", sum(x[:, cols] for x in ctx.in_list(op, "X")))


@register_lower("partial_concat")
def _partial_concat(ctx, op):
    cols = _column_range(op)
    ctx.set_out(op, "Out", torch.cat(
        [x[:, cols] for x in ctx.in_list(op, "X")], dim=1))


@register_lower("segment_pool")
def _segment_pool(ctx, op):
    x = ctx.in1(op, "X")
    seg = ctx.in1(op, "SegmentIds").long()
    pooltype = op.attr("pooltype", "SUM")
    n = x.shape[0]                   # segments bounded by the row count
    ones = x.new_ones((n, 1))
    counts = ones.new_zeros((n, 1)).index_add(0, seg, ones)
    if pooltype in ("SUM", "MEAN"):
        out = x.new_zeros(x.shape).index_add(0, seg, x)
        if pooltype == "MEAN":
            out = out / torch.clamp_min(counts, 1.0).reshape(
                (n,) + (1,) * (x.dim() - 1))
    else:
        # an empty segment keeps the buffer's value: the reduction's
        # identity, as in jax.ops.segment_max / segment_min
        big = float("-inf") if pooltype == "MAX" else float("inf")
        index = seg.reshape((n,) + (1,) * (x.dim() - 1)).expand(x.shape)
        out = torch.full_like(x, big).scatter_reduce(
            0, index, x, "amax" if pooltype == "MAX" else "amin",
            include_self=False)
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "SummedIds", counts)


@register_lower("p_norm")
def _p_norm(ctx, op):
    x = ctx.in1(op, "X")
    porder = float(op.attr("porder", 2.0))
    axis = op.attr("axis", None)
    keep = bool(op.attr("keepdim", False))
    if axis is None or axis == [] or bool(op.attr("asvector", False)):
        dims = tuple(range(x.dim()))
    else:
        dims = (int(axis),)
    a = torch.abs(x)
    if porder == float("inf"):
        out = torch.amax(a, dim=dims, keepdim=keep)
    elif porder == float("-inf"):
        out = torch.amin(a, dim=dims, keepdim=keep)
    else:
        out = torch.pow(torch.sum(torch.pow(a, porder), dim=dims,
                                  keepdim=keep), 1.0 / porder)
    ctx.set_out(op, "Out", out)


@register_lower("frobenius_norm")
def _frobenius_norm(ctx, op):
    x = ctx.in1(op, "X")
    dims = tuple(int(a) for a in op.attr("dim", []))
    if op.attr("reduce_all", False) or not dims:
        dims = tuple(range(x.dim()))
    ctx.set_out(op, "Out", torch.sqrt(torch.sum(
        torch.square(x), dim=dims, keepdim=bool(op.attr("keep_dim", False)))))


def backtrack_beams(ids, parents):
    """The beam ancestry walk shared by ``gather_tree`` and
    ``text.decode.beam_search``: ids / parents [T, B, W] (parents local to
    each batch's beam group) -> the beams re-threaded from the last step
    backwards, [T, B, W], chronological."""
    t, b, w = ids.shape
    parents = parents.long()
    rows = torch.arange(b, device=ids.device)[:, None]
    beam = torch.arange(w, device=ids.device).expand(b, w)
    outs = []
    for i in range(t - 1, -1, -1):
        outs.append(ids[i][rows, beam])
        beam = parents[i][rows, beam]
    return torch.stack(outs[::-1]) if outs else ids.clone()


@register_lower("gather_tree")
def _gather_tree(ctx, op):
    ctx.set_out(op, "Out", backtrack_beams(ctx.in1(op, "Ids"),
                                           ctx.in1(op, "Parents")))
