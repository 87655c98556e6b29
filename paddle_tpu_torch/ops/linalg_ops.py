"""Norms (``p_norm``, ``frobenius_norm``) and the beam-search ancestry
walk (``backtrack_beams``, the ``gather_tree`` op).

Counterpart of the norm rules of ``paddle_tpu/ops/misc.py`` (the tensor
API's ``norm`` reaches them; the JAX package's ``linalg_ops.py`` holds
ops the tensor API runs through ``apply_jax`` instead, and those run
torch directly here, ``tensor/linalg.py``).  Reference parity:
gather_tree_op.cc, p_norm_op.cc (``porder`` +-inf: the largest / smallest magnitude;
``asvector`` or no axis: over every element), frobenius_norm_op.cc.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower


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
