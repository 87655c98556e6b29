"""Control-flow op lowerings: ``while``, ``conditional_block`` and
``cond_pair``, each owning sub-blocks.

Counterpart of ``paddle_tpu/ops/control_flow.py`` (role parity: reference
paddle/fluid/operators/controlflow/ while_op.cc and
conditional_block_op.cc, built by layers/control_flow.py While:1020,
while_loop:1035, cond:2333).  The JAX package lowers them to
``lax.while_loop`` / ``lax.cond``; here they run eagerly: the predicate's
value is read on the host and a Python loop or branch lowers the
sub-block's ops through the same registry, an error naming the sub-block
op and where it was built.  A host read cannot sit inside a captured
graph, so a program holding one of these ops runs eagerly
(``framework/executor.capture_reason``, kind ``control_flow``).

The JAX package's loud errors stay, word for word where its tests match
them: a carried var whose shape or dtype changes; a var written in the
loop and read after it with no initial value; ``cond_pair`` branches
that disagree on an output's shape or dtype; a condition with more than
one element.  The branch that does not run is never run to check its
shapes: its outputs' declared shapes stand in, a -1 dim matching any
extent, where its inputs hold theirs (a static program, or a traced one
at its traced shapes); else it is lowered over ``meta`` tensors (shapes
and dtypes only), a nested control-flow op there lowering both its
branches and its loop body once.  ``conditional_block``'s false branch
keeps each output's previous value, or gives zeros where the output was
never defined.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import torch

from ..framework import dtypes
from ..framework.lowering import PSEUDO_OPS, LoweringContext, get_lowering, \
    register_lower

META = torch.device("meta")
# how torch (and py_func) word a meta tensor's missing data or kernel
_META_READ = re.compile(r"\bmeta (tensor|device)|'meta' backend", re.I)


def _run_sub_block(ctx, sub_block, env, device=None):
    """Lower every op of a sub-block into ``env`` (same registry); on
    another ``device`` (the meta probe) without the program's
    generator."""
    sub_ctx = LoweringContext(sub_block, env, device or ctx.device,
                              None if device is not None
                              else ctx._generator)
    for op in sub_block.ops:
        if op.type in PSEUDO_OPS:
            continue
        try:
            get_lowering(op.type)(sub_ctx, op)
        except Exception as e:
            site = op.callstack[-1] if op.callstack else "<unknown>"
            raise type(e)(
                f"while lowering sub-block op {op.type!r} (built at "
                f"{site}): {e}") from e
    return env


def _as_pred(ctx, value) -> Optional[bool]:
    """A single-element condition's truth, read on the host; None on the
    meta probe of a branch that does not run, which reads no value."""
    if value.numel() != 1:
        raise ValueError(
            f"control-flow condition must be a single element, got shape "
            f"{tuple(value.shape)}")
    if getattr(ctx.device, "type", None) == "meta":
        return None
    return bool(value.reshape(()).item())


def _sig(v) -> Tuple[torch.dtype, Tuple[int, ...]]:
    return v.dtype, tuple(v.shape)


def _fmt(sig) -> str:
    shape = "(?)" if sig[1] is None else sig[1]
    return f"{dtypes.to_str(sig[0])}{shape}"


def _to_meta(v):
    if isinstance(v, torch.Tensor):
        return torch.empty(v.shape, dtype=v.dtype, device=META)
    if isinstance(v, list):
        return [_to_meta(x) for x in v]
    return v


def _changed_dims(ctx, sub, reads) -> Optional[set]:
    """The declared dims of the vars ``sub`` reads from its surroundings
    that the run's values do not hold (empty: every read holds its
    declared shape, a -1 dim matching any extent; a scalar's one element
    saved and loaded as shape [1] counts).  None where that cannot be
    told: a tensor array, an undeclared var, another rank."""
    changed: set = set()
    for n in reads:
        v, var = ctx.env.get(n), sub._find_var_recursive(n)
        if not isinstance(v, torch.Tensor) or var is None:
            return None
        shape = tuple(var.shape)
        if v.numel() == 1 and shape in ((), (1,)):
            continue
        if len(shape) != v.dim():
            return None
        changed |= {d for d, e in zip(shape, v.shape) if 0 <= d != e}
    return changed


def _reads_a_value(e: BaseException) -> bool:
    """Whether a lowering on the meta probe failed because it needs a
    value (a host read, a ``py_func``, an op with no meta kernel): torch
    names the meta device in each of those errors, and in no shape
    error."""
    while e is not None:
        if _META_READ.search(str(e)):
            return True
        e = e.__cause__
    return False


def _branch_sigs(ctx, sub, names: Sequence[str],
                 concrete: bool = False) -> List[tuple]:
    """(dtype, shape) of each of ``names`` after ``sub`` would run,
    without running it.

    The declared shapes serve, a -1 dim matching any extent and an
    undeclared shape (None) any shape, where every var the branch reads
    from its surroundings holds its declared shape: a static program,
    whose builders checked the branches' shapes, or a traced one at its
    traced shapes, whose trace ran both branches.  ``concrete`` asks for
    every dim there.
    Else (a traced program run at other shapes) the branch is lowered
    over meta tensors, nested control flow by both its branches
    (torch's first meta arithmetic in a process imports its
    decompositions: seconds on the card's host, PERF.md).  Where a
    lowering there needs a value, the declared shapes serve again, each
    dim that a changed input dim could have set matching any extent
    (shape None: any shape).  Any other error of the probe is the
    branch's own and raises."""
    from ..framework.executor import _block_written, _sub_external_reads

    written = _block_written(ctx.program, sub.idx)
    declared = []
    for n in names:
        if n in ctx.env and n not in written:   # a pass-through output
            declared.append(_sig(ctx.env[n]))
            continue
        var = sub._find_var_recursive(n)
        declared.append((dtypes.to_torch(var.dtype),
                         tuple(int(d) for d in var.shape)))
    changed = _changed_dims(ctx, sub,
                            _sub_external_reads(ctx.program, sub.idx))
    if changed == set() and not (concrete and any(
            not shape or min(shape) < 0 for _, shape in declared)):
        return [(dtype, shape or None) for dtype, shape in declared]
    env = {n: _to_meta(v) for n, v in ctx.env.items()}
    try:
        _run_sub_block(ctx, sub, env, device=META)
    except Exception as e:  # noqa: BLE001 - re-raised unless a value read
        if not _reads_a_value(e):
            raise
        return [(dtype, tuple(-1 if changed is None or d in changed else d
                              for d in shape) if shape else None)
                for dtype, shape in declared]
    return [_sig(env[n]) for n in names]


def _same(a, b) -> bool:
    """Whether two (dtype, shape) signatures agree; a declared -1 dim
    matches any extent, and an unknown shape (None) any shape."""
    if a[0] != b[0]:
        return False
    if a[1] is None or b[1] is None:
        return True
    return len(a[1]) == len(b[1]) and all(
        x == y or x < 0 or y < 0 for x, y in zip(a[1], b[1]))


def _check_branches(t_sigs, f_sigs):
    for n, (t, f) in enumerate(zip(t_sigs, f_sigs)):
        if not _same(t, f):
            raise TypeError(
                f"cond branches disagree on output {n}: true_fn gives "
                f"{_fmt(t)}, false_fn gives {_fmt(f)}")


def _loop_body(ctx, sub, carry_names, carry, sigs):
    """One pass of a ``while`` body over ``carry``; its new values."""
    env = dict(ctx.env)
    env.update(zip(carry_names, carry))
    _run_sub_block(ctx, sub, env)
    for n, sig in zip(carry_names, sigs):
        if _sig(env[n]) != sig:
            raise TypeError(
                f"while loop carried var {n!r} changed from "
                f"{_fmt(sig)} to {_fmt(_sig(env[n]))}; the port's loops, "
                f"as XLA's, need loop-invariant shapes/dtypes")
    return [env[n] for n in carry_names]


@register_lower("while")
def _while(ctx, op):
    sub = ctx.program.blocks[int(op.attr("sub_block"))]
    cond_name = op.inputs["Condition"][0]
    carry_names = list(op.inputs.get("X", []))
    if cond_name not in carry_names:
        carry_names = [cond_name] + carry_names

    # loud guard: a var written only inside the loop but read by later
    # parent ops has no initial carry value: tell the user to initialize
    # it before the loop so it becomes loop state (fluid scope semantics
    # tolerate this; explicit carry does not)
    sub_written = {n for sop in sub.ops for n in sop.output_arg_names()}
    after = False
    escaping = set()
    for pop in ctx.block.ops:
        if pop is op:
            after = True
            continue
        if after:
            for n in pop.input_arg_names():
                if n in sub_written and n not in carry_names \
                        and n not in ctx.env:
                    escaping.add(n)
    if escaping:
        raise ValueError(
            f"vars {sorted(escaping)} are written inside the while loop and "
            f"read after it, but were never initialized before the loop; "
            f"give them an initial value (e.g. fill_constant) before the "
            f"loop so they join the carried state")

    carry = [ctx.get(n) for n in carry_names]
    sigs = [_sig(v) for v in carry]
    ci = carry_names.index(cond_name)
    if _as_pred(ctx, carry[ci]) is None:
        # the carried state keeps its shapes and dtypes: one pass of the
        # body over meta checks that, as lax.while_loop's trace does
        carry = _loop_body(ctx, sub, carry_names, carry, sigs)
    else:
        while _as_pred(ctx, carry[ci]):
            carry = _loop_body(ctx, sub, carry_names, carry, sigs)
    for n, v in zip(carry_names, carry):
        ctx.set(n, v)


@register_lower("conditional_block")
def _conditional_block(ctx, op):
    """Predicated single-branch execution (conditional_block_op.cc): when
    the condition is false, outputs keep their previous values (zeros
    when previously undefined).  On the meta probe the outputs take the
    branch's shapes."""
    sub = ctx.program.blocks[int(op.attr("sub_block"))]
    out_names = list(op.outputs.get("Out", []))
    if _as_pred(ctx, ctx.in1(op, "Cond")) is not False:
        env = _run_sub_block(ctx, sub, dict(ctx.env))
        for n in out_names:
            ctx.set(n, env[n])
        return
    sigs = _branch_sigs(ctx, sub, out_names,
                        concrete=any(n not in ctx.env for n in out_names))
    for n, (dtype, shape) in zip(out_names, sigs):
        if n in ctx.env:
            ctx.set(n, ctx.env[n].to(dtype))
        elif shape is None or min(shape, default=0) < 0:
            raise ValueError(
                f"conditional_block output {n!r} was never defined and "
                f"its shape {_fmt((dtype, shape))} is not known without "
                f"running the branch; give it a value before the block")
        else:
            ctx.set(n, torch.zeros(shape, dtype=dtype, device=ctx.device))


@register_lower("cond_pair")
def _cond_pair(ctx, op):
    """Two-branch functional cond (the 2.0 ``layers.cond`` builder and
    dy2static's traced ``if``): both branches are sub-blocks, their
    output names recorded in attrs; the taken branch's outputs land in
    the op's ``Out`` names.  On the meta probe both branches are lowered
    over meta and must agree."""
    subs = (ctx.program.blocks[int(op.attr("sub_block_t"))],
            ctx.program.blocks[int(op.attr("sub_block_f"))])
    outs = (list(op.attr("t_outs", []) or []),
            list(op.attr("f_outs", []) or []))
    pred = _as_pred(ctx, ctx.in1(op, "Cond"))
    if pred is None:
        envs = [_run_sub_block(ctx, s, dict(ctx.env)) for s in subs]
        t_vals, f_vals = ([env[n] for n in o] for env, o in zip(envs, outs))
        _check_branches([_sig(v) for v in t_vals], [_sig(v) for v in f_vals])
        vals = t_vals
    else:
        taken = 0 if pred else 1
        other_sigs = _branch_sigs(ctx, subs[1 - taken], outs[1 - taken])
        env = _run_sub_block(ctx, subs[taken], dict(ctx.env))
        vals = [env[n] for n in outs[taken]]
        sigs = [_sig(v) for v in vals]
        _check_branches(*((sigs, other_sigs) if taken == 0
                          else (other_sigs, sigs)))
    for n, v in zip(op.outputs.get("Out", []), vals):
        ctx.set(n, v)
