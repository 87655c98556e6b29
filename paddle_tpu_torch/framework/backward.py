"""Graph autodiff: append_backward over program blocks.

Copy of ``paddle_tpu/framework/backward.py`` (the JAX package's
module imports no JAX); the program it builds holds the same ops.  One
order differs by design: with ``checkpoints`` (activation recompute),
each re-emitted forward op is placed just before the first gradient op
that reads what it recomputes, so the segments are rebuilt one at a
time, last segment first, as the reference's
``_append_backward_ops_with_checkpoints_`` places them.  The JAX package
emits them all at the backward's start and leaves the schedule to XLA;
the port runs ops in program order and frees each value at its last
use, so only this order keeps a single segment's activations alive.
``calc_gradient`` takes several targets and seeds each with its entry
of ``target_gradients``, as the reference's does; the JAX package's
takes one target and seeds it with ones.

Role parity: reference python/paddle/fluid/backward.py (`append_backward`
:1275 — reverse walk, per-op grad-op makers, sum-op insertion on fan-out,
`calc_gradient`:1728) and the C++ GradOpDescMaker registry
(framework/grad_op_desc_maker.h).

TPU-native twist: most ops need no hand-written grad kernel.  The default
grad maker emits a single ``<type>_grad`` op carrying the forward op's
slots; its default lowering (ops/grad_generic.py) rebuilds the forward
computation at trace time and applies ``jax.vjp``.  Because forward and
backward live in ONE compiled XLA computation, XLA CSEs the recomputed
forward — so this costs nothing at runtime while giving every registered
forward op an automatic, exact gradient.  Ops where recompute is wrong
(randomness) or wasteful register explicit makers/lowerings.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional

from . import dtypes
from .program import Block, Operator, Variable, grad_var_name

GRAD_SUFFIX = "@GRAD"

# forward op type -> maker(bwd_ctx, op, out_grads) -> {input_name: grad_name}
GRAD_MAKERS: Dict[str, Callable] = {}

# ops that terminate gradient flow
NO_GRAD_OPS = {
    "fill_constant",
    "gaussian_random",
    "uniform_random",
    "truncated_gaussian_random",
    "randint",
    "randperm",
    "feed",
    "fetch",
    "shape",
    "size",
    "accuracy",
    "auc",
    "arg_max",
    "arg_min",
    "equal",
    "not_equal",
    "less_than",
    "less_equal",
    "greater_than",
    "greater_equal",
    "logical_and",
    "logical_or",
    "logical_not",
    "logical_xor",
    "assign_value",
    "eye",
    "range",
    "linspace",
    "one_hot",
    "one_hot_v2",
    "increment",
    "print",
    "isfinite",
    "isfinite_v2",
    "isnan_v2",
    "isinf_v2",
}


def register_grad_maker(*op_types: str):
    def deco(fn):
        for t in op_types:
            GRAD_MAKERS[t] = fn
        return fn

    return deco


class BackwardContext:
    """State for one append_backward pass over a block."""

    def __init__(self, block: Block, no_grad_set):
        self.block = block
        self.no_grad_set = set(no_grad_set or ())
        self._rename_counter = defaultdict(int)

    def wants_grad(self, name: str) -> bool:
        if name in self.no_grad_set:
            return False
        var = self.block._find_var_recursive(name)
        if var is None:
            return True  # unknown vars: be permissive
        if var.stop_gradient:
            return False
        return dtypes.is_floating(var.dtype)

    def grad_contribution_name(self, name: str, pending: dict) -> str:
        """Canonical grad name, or a renamed one if contributions already exist."""
        base = grad_var_name(name)
        n = len(pending.get(name, []))
        if n == 0:
            return base
        self._rename_counter[name] += 1
        return f"{base}@RENAME@{self._rename_counter[name]}"

    def ensure_grad_var(self, gname: str, like: Optional[str]):
        if self.block.has_var(gname):
            return
        var = self.block._find_var_recursive(like) if like else None
        self.block.create_var(
            name=gname,
            shape=var.shape if var is not None else (),
            dtype=var.dtype if var is not None else "float32",
            stop_gradient=True,
        )

    def append(self, type, inputs, outputs, attrs=None) -> Operator:
        return self.block.append_op(type, inputs, outputs, attrs)


def default_grad_maker(bctx: BackwardContext, op: Operator, out_grads: Dict[str, str]):
    """Emit one generic `<type>_grad` op (lowered by ops/grad_generic.py)."""
    gtype = op.type + "_grad"
    inputs = {}
    for slot, names in op.inputs.items():
        inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        inputs[slot] = list(names)
        gnames = [out_grads.get(n, "") for n in names]
        if any(gnames):
            inputs[slot + GRAD_SUFFIX] = gnames
    outputs = {}
    produced = {}
    for slot, names in op.inputs.items():
        gouts = []
        any_grad = False
        for n in names:
            if bctx.wants_grad(n):
                g = f"__pending__{n}"  # placeholder; caller renames
                gouts.append(g)
                any_grad = True
            else:
                gouts.append("")
        if any_grad:
            outputs[slot + GRAD_SUFFIX] = gouts
    attrs = dict(op.attrs)
    attrs["__fwd_type__"] = op.type
    attrs["__fwd_out_slots__"] = list(op.outputs.keys())
    gop = Operator(bctx.block, gtype, inputs, outputs, attrs)
    return gop


def _finalize_out_grads(bctx, pending, op) -> Dict[str, str]:
    """Collapse pending contributions for each of op's outputs into one grad
    var, inserting a sum op on fan-out (reference backward.py sum-op logic)."""
    out_grads = {}
    for out_name in dict.fromkeys(op.output_arg_names()):
        contribs = pending.get(out_name)
        if not contribs:
            continue
        if len(contribs) == 1:
            out_grads[out_name] = contribs[0]
        else:
            target = grad_var_name(out_name)
            bctx.ensure_grad_var(target, out_name)
            bctx.append("sum", {"X": list(contribs)}, {"Out": target})
            out_grads[out_name] = target
        pending[out_name] = [out_grads[out_name]]
    return out_grads


RECOMPUTE_SUFFIX = "@RECOMPUTE"

# ops whose outputs must NOT be recomputed (re-running them yields different
# values): keep their stored outputs in the backward instead
_NONDETERMINISTIC_OPS = {
    "dropout", "gaussian_random", "uniform_random",
    "truncated_gaussian_random", "randint", "randperm",
}


def _emit_recompute_segments(bctx, block, fwd_ops, checkpoints, keep_names):
    """Activation recompute (reference backward.py:689
    `_append_backward_ops_with_checkpoints_`): re-emit forward ops so the
    backward reads fresh copies of non-checkpoint activations instead of
    keeping them alive from the forward pass.

    TPU-native twist: forward+backward are ONE XLA computation, so naive
    duplication would be CSE'd straight back.  Each checkpoint/param/feed
    entering a recomputed segment is routed through a `recompute_barrier`
    op (lowered to lax.optimization_barrier) which blocks CSE — XLA then
    truly recomputes the segment in the backward and frees the original
    activations after the forward.

    Returns {activation_name -> recomputed_name} for the grad emission to
    rename against.
    """
    ckpt = set(checkpoints)
    keep = set(keep_names) | ckpt
    rc_map: Dict[str, str] = {}
    barriered: Dict[str, str] = {}

    def barrier(name: str) -> str:
        if name not in barriered:
            bname = name + "@RCBAR"
            bctx.ensure_grad_var(bname, name)
            bctx.append("recompute_barrier", {"X": [name]}, {"Out": [bname]})
            barriered[name] = bname
        return barriered[name]

    for op in fwd_ops:
        if op.type in _NONDETERMINISTIC_OPS or op.type in NO_GRAD_OPS:
            continue
        outs = [n for n in op.output_arg_names() if n and n not in keep]
        if not outs:
            continue
        var_ok = True
        for n in outs:
            v = block._find_var_recursive(n)
            if v is not None and v.persistable:
                var_ok = False
        if not var_ok:
            continue
        new_inputs = {}
        for slot, names in op.inputs.items():
            renamed = []
            for n in names:
                if n in rc_map:
                    renamed.append(rc_map[n])
                else:
                    # EVERY external input (checkpoint, param, feed) enters
                    # through the barrier — otherwise the re-emitted ops
                    # have byte-identical inputs to the originals and XLA
                    # CSEs the duplicate away, keeping activations alive
                    renamed.append(barrier(n))
            new_inputs[slot] = renamed
        new_outputs = {}
        for slot, names in op.outputs.items():
            renamed = []
            for n in names:
                if n and n not in keep:
                    rn = n + RECOMPUTE_SUFFIX
                    bctx.ensure_grad_var(rn, n)
                    rc_map[n] = rn
                    renamed.append(rn)
                else:
                    renamed.append(n)
            new_outputs[slot] = renamed
        bctx.append(op.type, new_inputs, new_outputs, dict(op.attrs))
    return rc_map


def _recompute_emitter(block, rc_ops, rc_map):
    """``emit(names)`` appends the re-emitted ops (in ``rc_ops``, forward
    order) that produce ``names``, with whatever of ``rc_ops`` they read
    in turn, each op once and in forward order; ``emit(None)`` appends
    the ones left.  Only the names recompute made (``rc_map``'s values and
    the barriers' outputs) count as produced: a re-emitted op also
    rewrites the kept names among its outputs (a checkpoint, with the
    same value), and those are read from the forward."""
    fresh = set(rc_map.values())
    producer = {}
    for i, op in enumerate(rc_ops):
        for n in op.output_arg_names():
            if n in fresh or op.type == "recompute_barrier":
                producer[n] = i
    done = set()

    def emit(names):
        if names is None:
            need = [i for i in range(len(rc_ops)) if i not in done]
            done.update(need)
        else:
            need = []
            stack = [producer[n] for n in names if n in producer]
            while stack:
                i = stack.pop()
                if i in done:
                    continue
                done.add(i)
                need.append(i)
                stack.extend(producer[n] for n in rc_ops[i].input_arg_names()
                             if n in producer)
        for i in sorted(need):
            block.ops.append(rc_ops[i])
        if need:
            block.program._bump()

    return emit


def append_backward(
    loss: Variable,
    parameter_list=None,
    no_grad_set=None,
    callbacks=None,
    checkpoints=None,
):
    """Append grad ops computing d(loss)/d(params); returns [(param, grad)].

    Only root-block autodiff (control-flow sub-block autodiff arrives with
    the control-flow lowering)."""
    return _append_backward([(loss, None)], parameter_list, no_grad_set,
                            checkpoints)


def _append_backward(seeds, parameter_list, no_grad_set, checkpoints):
    """The backward of ``seeds`` [(target, its gradient var or None)]: a
    target without one is seeded with ones of its shape."""
    block = seeds[0][0].block
    program = block.program
    bctx = BackwardContext(block, no_grad_set)

    fwd_ops = list(block.ops)

    pending: Dict[str, List[str]] = defaultdict(list)
    for target, given in seeds:
        if given is not None:
            pending[target.name].append(getattr(given, "name", given))
            continue
        # d target / d target = 1
        target_grad = grad_var_name(target.name)
        bctx.ensure_grad_var(target_grad, target.name)
        block.append_op(
            "fill_constant",
            {},
            {"Out": target_grad},
            {
                "shape": list(target.shape),
                "value": 1.0,
                "dtype": target.dtype,
            },
        )
        pending[target.name].append(target_grad)

    # activation recompute: re-emit forward segments behind a CSE fence and
    # point grad ops at the recomputed copies (reference backward.py:689)
    rc_map: Dict[str, str] = {}
    emit_rc = None
    if checkpoints:
        keep = {p.name for p in program.all_parameters()}
        mark = len(block.ops)
        rc_map = _emit_recompute_segments(
            bctx, block, fwd_ops, [getattr(c, "name", c) for c in checkpoints],
            keep)
        # held back, then placed before the first gradient op reading them
        emit_rc = _recompute_emitter(block, block.ops[mark:], rc_map)
        del block.ops[mark:]

    for op in reversed(fwd_ops):
        if op.type in NO_GRAD_OPS:
            continue
        if not any(pending.get(o) for o in op.output_arg_names()):
            continue
        out_grads = _finalize_out_grads(bctx, pending, op)
        if not out_grads:
            continue
        maker = GRAD_MAKERS.get(op.type, default_grad_maker)
        gop = maker(bctx, op, out_grads)
        if gop is None:
            continue
        gops = gop if isinstance(gop, (list, tuple)) else [gop]
        if rc_map:
            # forward-value slots read the recomputed copies; @GRAD slots
            # keep original-derived names (the grad graph's own wiring)
            for g in gops:
                for slot, names in list(g.inputs.items()):
                    if slot.endswith(GRAD_SUFFIX):
                        continue
                    g.inputs[slot] = [rc_map.get(n, n) for n in names]
        for g in gops:
            # resolve placeholder grad names to (possibly renamed) real ones
            for slot, names in list(g.outputs.items()):
                resolved = []
                for n in names:
                    if n.startswith("__pending__"):
                        src = n[len("__pending__") :]
                        gname = bctx.grad_contribution_name(src, pending)
                        bctx.ensure_grad_var(gname, src)
                        pending[src].append(gname)
                        resolved.append(gname)
                    elif n:
                        resolved.append(n)
                    else:
                        resolved.append("")
                g.outputs[slot] = [r for r in resolved]
            if emit_rc is not None:
                emit_rc(g.input_arg_names())
            block.ops.append(g)
            program._bump()
    if emit_rc is not None:
        emit_rc(None)

    # collect (param, grad) pairs
    if parameter_list is not None:
        params = [
            block.var(p) if isinstance(p, str) else p for p in parameter_list
        ]
    else:
        params = [v for v in program.all_parameters() if v.trainable]
    params_and_grads = []
    for p in params:
        contribs = pending.get(p.name, [])
        if not contribs:
            continue
        if len(contribs) > 1:
            target = grad_var_name(p.name)
            bctx.ensure_grad_var(target, p.name)
            bctx.append("sum", {"X": list(contribs)}, {"Out": target})
        else:
            target = contribs[0]
            canonical = grad_var_name(p.name)
            if target != canonical:
                bctx.ensure_grad_var(canonical, p.name)
                bctx.append("assign", {"X": target}, {"Out": canonical})
                target = canonical
        params_and_grads.append((p, block.var(target)))
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of `targets` w.r.t. arbitrary `inputs` (reference
    backward.py:1728), None for an input no target reaches.  Each target
    is seeded with its entry of `target_gradients` (a var of the
    target's shape), or with ones where that entry or the argument is
    None.  Root block only."""
    tgts = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    given = target_gradients
    if given is None:
        given = [None] * len(tgts)
    elif not isinstance(given, (list, tuple)):
        given = [given]
    if len(given) != len(tgts):
        raise ValueError(f"calc_gradient: {len(given)} target_gradients for "
                         f"{len(tgts)} targets")
    pg = _append_backward(list(zip(tgts, given)), [v.name for v in ins],
                          no_grad_set, None)
    by_name = {p.name: g for p, g in pg}
    return [by_name.get(v.name) for v in ins]


# ---------------------------------------------------------------------------
# explicit grad makers for ops with special backward contracts
# ---------------------------------------------------------------------------


@register_grad_maker("softmax_with_cross_entropy")
def _swce_maker(bctx, op, out_grads):
    loss_g = out_grads.get(op.output("Loss")[0])
    if loss_g is None:
        return default_grad_maker(bctx, op, out_grads)
    logits = op.input("Logits")[0]
    if not bctx.wants_grad(logits):
        return None
    return Operator(
        bctx.block,
        "softmax_with_cross_entropy_grad",
        {
            "Softmax": op.output("Softmax"),
            "Label": op.input("Label"),
            "Loss@GRAD": [loss_g],
        },
        {"Logits@GRAD": [f"__pending__{logits}"]},
        dict(op.attrs),
    )


@register_grad_maker("dropout")
def _dropout_maker(bctx, op, out_grads):
    g = out_grads.get(op.output("Out")[0])
    x = op.input("X")[0]
    if g is None or not bctx.wants_grad(x):
        return None
    return Operator(
        bctx.block,
        "dropout_grad",
        {"Mask": op.output("Mask"), "Out@GRAD": [g]},
        {"X@GRAD": [f"__pending__{x}"]},
        dict(op.attrs),
    )


@register_grad_maker("mean")
def _mean_maker(bctx, op, out_grads):
    g = out_grads.get(op.output("Out")[0])
    x = op.input("X")[0]
    if g is None or not bctx.wants_grad(x):
        return None
    return Operator(
        bctx.block,
        "mean_grad",
        {"X": [x], "Out@GRAD": [g]},
        {"X@GRAD": [f"__pending__{x}"]},
    )


@register_grad_maker("reshape2", "reshape")
def _reshape_maker(bctx, op, out_grads):
    g = out_grads.get(op.output("Out")[0])
    x = op.input("X")[0]
    if g is None or not bctx.wants_grad(x):
        return None
    return Operator(
        bctx.block,
        "reshape_like_grad",
        {"X": [x], "Out@GRAD": [g]},
        {"X@GRAD": [f"__pending__{x}"]},
    )


@register_grad_maker("transpose2", "transpose")
def _transpose_maker(bctx, op, out_grads):
    g = out_grads.get(op.output("Out")[0])
    x = op.input("X")[0]
    if g is None or not bctx.wants_grad(x):
        return None
    return Operator(
        bctx.block,
        "transpose2_grad",
        {"Out@GRAD": [g]},
        {"X@GRAD": [f"__pending__{x}"]},
        {"axis": list(op.attr("axis", []))},
    )


@register_grad_maker("while")
def _while_maker(bctx, op, out_grads):
    raise NotImplementedError(
        "gradients through `while` loops are not supported: `while` runs "
        "eagerly, its predicate read on the host each iteration, and has "
        "no gradient rule. For a differentiable recurrence use the `rnn` "
        "op (lstm/gru/rnn on cuDNN) or unroll a fixed-length loop")


@register_grad_maker("assign", "share_data")
def _assign_maker(bctx, op, out_grads):
    g = out_grads.get(op.output("Out")[0])
    x = op.input("X")[0]
    if g is None or not bctx.wants_grad(x):
        return None
    return Operator(
        bctx.block, "assign", {"X": [g]}, {"Out": [f"__pending__{x}"]}
    )
