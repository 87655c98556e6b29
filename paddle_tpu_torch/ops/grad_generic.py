"""Generic gradient lowering: autograd over the replayed forward.

Counterpart of ``paddle_tpu/ops/grad_generic.py``.  Any ``<type>_grad``
op without an explicit lowering lands here.  The op carries the forward
op's full slots + attrs (see backward.default_grad_maker); we replay the
forward lowering on copies of its float inputs that require grad, and
pull the output cotangents back with ``torch.autograd.grad``.

Cost: in the JAX package forward and backward share one XLA computation,
whose CSE removes the replayed forward.  Run eagerly, every op with a
generic gradient runs its forward twice a step (the fused attention op,
and the flash kernel with it, included).  Keeping the forward's autograd
graph alive until its gradient op instead is queued work.
"""
from __future__ import annotations

import torch

from ..framework import lowering as _lowering
from ..framework.lowering import LoweringContext, register_lower
from ..framework.program import Operator

GRAD_SUFFIX = "@GRAD"


def _is_float(v) -> bool:
    return isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex())


def lower_generic_grad(ctx: LoweringContext, gop) -> None:
    fwd_type = gop.attr("__fwd_type__")
    if not fwd_type:
        raise NotImplementedError(
            f"op {gop.type!r}: no lowering and no __fwd_type__ attr for the "
            "generic gradient path")
    out_slots = set(gop.attr("__fwd_out_slots__", []) or [])
    in_slots = [s for s in gop.inputs
                if s not in out_slots and not s.endswith(GRAD_SUFFIX)]
    fwd_lower = _lowering.get_lowering(fwd_type)
    attrs = {k: v for k, v in gop.attrs.items() if not k.startswith("__fwd_")}
    fwd_inputs = {s: list(gop.inputs[s]) for s in in_slots}
    fwd_outputs = {s: list(gop.inputs[s]) for s in out_slots
                   if s in gop.inputs}

    # which (slot, idx) need grads, and which of them are floats
    want = {}  # slot -> [(idx, grad_out_name)]
    for s in in_slots:
        pairs = [(i, g) for i, g in
                 enumerate(gop.outputs.get(s + GRAD_SUFFIX, [])) if g]
        if pairs:
            want[s] = pairs
    diff_args = [(s, i) for s, pairs in want.items() for i, _ in pairs
                 if _is_float(ctx.get(fwd_inputs[s][i]))]

    if not diff_args:
        # nothing differentiable wanted; emit zeros for requested int grads
        for s, pairs in want.items():
            for i, gname in pairs:
                ctx.set(gname, torch.zeros_like(ctx.get(fwd_inputs[s][i])))
        return

    env = {n: ctx.get(n) for s in in_slots for n in fwd_inputs[s]}
    leaves = []
    for s, i in diff_args:
        leaf = ctx.get(fwd_inputs[s][i]).detach().requires_grad_(True)
        env[fwd_inputs[s][i]] = leaf
        leaves.append(leaf)
    fop = Operator.__new__(Operator)
    fop.block = ctx.block
    fop.type = fwd_type
    fop.inputs = fwd_inputs
    fop.outputs = fwd_outputs
    fop.attrs = attrs
    fop.callstack = gop.callstack
    with torch.enable_grad():
        # no generator: a forward that draws random numbers cannot be
        # replayed (dropout has its own gradient lowering)
        fwd_lower(LoweringContext(ctx.block, env, ctx.device), fop)

    outs, cots = [], []
    for s in fwd_outputs:
        gnames = gop.inputs.get(s + GRAD_SUFFIX, [])
        for j, n in enumerate(fwd_outputs[s]):
            out = env[n]
            gname = gnames[j] if j < len(gnames) else ""
            # a missing cotangent is zero: leaving the output out is the
            # same pull-back
            if gname and _is_float(out) and out.requires_grad:
                outs.append(out)
                cots.append(ctx.get(gname).to(out.dtype))
    grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True) \
        if outs else [None] * len(leaves)

    grad_by_arg = dict(zip(diff_args, grads))
    for s, pairs in want.items():
        for i, gname in pairs:
            val = ctx.get(fwd_inputs[s][i])
            g = grad_by_arg.get((s, i))
            ctx.set(gname, torch.zeros_like(val) if g is None
                    else g.to(val.dtype))


# install as the fallback for unregistered *_grad ops
_lowering.GENERIC_GRAD_LOWERING = lower_generic_grad


@register_lower("reshape_like_grad")
def _reshape_like_grad(ctx, op):
    dy = ctx.in1(op, "Out@GRAD")
    x = ctx.in1(op, "X")
    ctx.set_out(op, "X@GRAD", dy.reshape(x.shape))
