"""Eager op dispatch: run a registered lowering rule immediately.

Counterpart of ``paddle_tpu/dygraph/eager.py``.  ``run_op`` runs the SAME
rule the static executor runs (``framework/lowering.py``), now, on the
inputs' torch tensors, through a ``LoweringContext`` over an eager block
stand-in, on the inputs' device with that device's generator
(``base.generator``).  The tape is ``torch.autograd``: the lowerings are
functional ATen code (none writes into its inputs), so autograd records
each op as it runs, and ``backward`` is autograd's.  This replaces the
JAX package's ``TapeNode`` and its VJP replay.

AMP (``amp.auto_cast``): the white / black / gray-follow casts of the
JAX package's ``_amp_policy`` are applied to the op's floating inputs
before its rule runs, so autograd differentiates through them and float32
master parameters get float32 gradients.

Batch norm is the one op whose eager rule is not its lowering
(``_EAGER_RULES``): its batch statistics go through an autograd
``Function`` whose backward is the closed form of the static
``batch_norm_grad``, where autograd through the lowering would
differentiate the one-pass moments pass by pass.

``run_op`` runs about 320 times a ResNet-50 forward: it builds one
dict of values and one op stand-in, and nothing else, per call.

Dygraph-to-static (``dygraph/jit.py``): while a trace is active,
``_TRACE_REC`` holds its recorder and each op, once run, is recorded
into the program being built, its inputs named by the ``Tensor`` objects
that went in.  The check is one read of a module global, so an untraced
``run_op`` pays nothing else.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..framework.lowering import LoweringContext, get_lowering
from ..ops.nn_ops import batch_norm_eager
from . import base
from .tensor import Tensor, _as_torch, _wrap

# default output slot names per op family; ops not listed produce "Out".
_OUT_SLOTS: Dict[str, Sequence[str]] = {
    "batch_norm": ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
    "sync_batch_norm": ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
    "layer_norm": ("Y", "Mean", "Variance"),
    "group_norm": ("Y", "Mean", "Variance"),
    "instance_norm": ("Y", "SavedMean", "SavedVariance"),
    "softmax_with_cross_entropy": ("Loss", "Softmax"),
    "top_k": ("Out", "Indices"),
    "top_k_v2": ("Out", "Indices"),
    "argsort": ("Out", "Indices"),
    "dropout": ("Out", "Mask"),
    "reshape2": ("Out", "XShape"),
    "transpose2": ("Out", "XShape"),
    "squeeze2": ("Out", "XShape"),
    "unsqueeze2": ("Out", "XShape"),
    "flatten2": ("Out", "XShape"),
    "unstack": ("Y",),
    "split": ("Out",),
    "check_finite_and_unscale": ("Out", "FoundInfinite"),
    "update_loss_scaling": ("Out", "LossScaling", "OutGoodSteps", "OutBadSteps"),
    "accuracy": ("Accuracy", "Correct", "Total"),
    "relu": ("Out",),
}

# ops whose eager rule is not the registered lowering
_EAGER_RULES = {"batch_norm": batch_norm_eager,
                "sync_batch_norm": batch_norm_eager}

# ops whose listed output slot is a LIST with the same length as input list
_LIST_OUT_OPS = {"split": "Out", "unstack": "Y", "meshgrid": "Out",
                 "check_finite_and_unscale": "Out"}

# active dygraph->static program recorder (set by jit._trace_guard)
_TRACE_REC = None

# bound on first use (amp imports the framework; keep eager import-light)
_AMP_STATE = None


def _amp_state():
    global _AMP_STATE
    if _AMP_STATE is None:
        from ..amp import amp_state

        _AMP_STATE = amp_state()
    return _AMP_STATE


def _amp_policy(op_type):
    """Dygraph autocast policy (reference imperative/amp_auto_cast.cc
    NeedCast:51): (cast dtype or None, gray-follow dtype or None)."""
    st = _amp_state()
    if not st.enabled:
        return None, None
    if op_type in st.lists.white_list:
        return st.torch_dtype, None
    if op_type in st.lists.black_list:
        return torch.float32, None
    if op_type in st.lists.gray_follow_cast:
        return None, st.torch_dtype
    return None, None


_LOW = (torch.bfloat16, torch.float16)


def _amp_cast(op_type, env):
    cast_to, follow = _amp_policy(op_type)
    if follow is not None and any(
            v.dtype in _LOW for v in env.values()):
        cast_to = follow
    if cast_to is not None:
        for n, v in env.items():
            if v.is_floating_point() and v.dtype != cast_to:
                env[n] = v.to(cast_to)


class _EagerOp:
    """Duck-typed Operator (framework/program.py) for eager dispatch."""

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs

    def input(self, slot):
        return list(self.inputs.get(slot, []))

    def output(self, slot):
        return list(self.outputs.get(slot, []))

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs


class _EagerBlock:
    """Minimal Block stand-in so LoweringContext works outside a Program."""

    program = None

    def _find_var_recursive(self, name):
        return None


_EAGER_BLOCK = _EagerBlock()


def apply_torch(fn, *tensors, n_out: int = 1):
    """Run ``fn`` on the tensors' torch values (autograd records it) and
    wrap what it returns.  The eager escape hatch for operations with no
    IR op (indexing, casts): the counterpart of ``apply_jax``."""
    from ..framework.program import Variable

    if any(isinstance(t, Variable) for t in tensors):
        raise NotImplementedError(
            "this operation has no static-graph lowering yet; it only works "
            "in dygraph mode (got a graph Variable)")
    out = fn(*(t._value if isinstance(t, Tensor) else t for t in tensors))
    outs = [_wrap(o) for o in (out if isinstance(out, tuple) else (out,))]
    return outs[0] if n_out == 1 and len(outs) == 1 else outs


def run_op(op_type: str, inputs: Dict[str, object], attrs: Optional[dict] = None,
           out_slots: Optional[Sequence[str]] = None,
           out_counts: Optional[Dict[str, int]] = None) -> Dict[str, object]:
    """Execute one IR op eagerly.  Returns {slot: Tensor | [Tensor]}.

    `inputs` values may be Tensor, list[Tensor], or None (optional slot);
    other values (numbers, numpy arrays) become tensors on the inputs'
    device.
    """
    rule = _EAGER_RULES.get(op_type) or get_lowering(op_type)
    if out_slots is None:
        out_slots = _OUT_SLOTS.get(op_type, ("Out",))
    env, in_names, raw, device = {}, {}, [], None
    for slot, v in inputs.items():
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            names = in_names[slot] = [f"{slot}.{i}" for i in range(len(v))]
            items = zip(names, v)
        else:
            in_names[slot] = [slot]
            items = ((slot, v),)
        for n, t in items:
            if isinstance(t, Tensor):
                env[n] = t = t._value
            elif isinstance(t, torch.Tensor):
                env[n] = t
            else:
                raw.append((n, t))
                continue
            if device is None:
                device = t.device
    if device is None:
        device = base.current_device()
    for n, t in raw:
        env[n] = _as_torch(t, device)
    if _amp_state().enabled:
        _amp_cast(op_type, env)
    counts = out_counts or {}
    out_names = {s: [f"@{s}.{i}" for i in range(counts.get(s, 1))]
                 for s in out_slots}
    op = _EagerOp(op_type, in_names, out_names, dict(attrs or {}))
    rule(LoweringContext(_EAGER_BLOCK, env, device, base.generator(device)),
         op)
    result, produced = {}, False
    for slot, names in out_names.items():
        ts = [None if env.get(n) is None else _wrap(env[n]) for n in names]
        produced = produced or any(t is not None for t in ts)
        if _LIST_OUT_OPS.get(op_type) == slot:
            result[slot] = [t for t in ts if t is not None]
        else:
            result[slot] = ts[0] if len(ts) == 1 else ts
    if out_names and not produced:
        raise RuntimeError(
            f"op {op_type!r} produced none of the requested output slots "
            f"{list(out_slots)}; the lowering writes different slot names")
    if _TRACE_REC is not None:
        _TRACE_REC.record(op_type, _traced_inputs(inputs, in_names, env),
                          attrs, result, out_slots)
    return result


def _traced_inputs(inputs, in_names, env) -> Dict[str, list]:
    """The op's inputs as ``Tensor`` objects, slot by slot, for the
    recorder: the caller's own ``Tensor`` where one went in (its identity
    names the var), else a new one over the value ``run_op`` made of it
    (a number, an array or a bare torch tensor: a constant of the trace)."""
    out = {}
    for slot, names in in_names.items():
        v = inputs[slot]
        items = v if isinstance(v, (list, tuple)) else (v,)
        out[slot] = [t if isinstance(t, Tensor) else _wrap(env[n])
                     for n, t in zip(names, items)]
    return out


class Tracer:
    """API-parity shim over the global dygraph state (reference
    imperative::Tracer): ``trace_op`` runs an op and hands each result to
    the caller's own output ``Tensor``."""

    @property
    def _has_grad(self):
        return base.grad_enabled()

    def trace_op(self, type, inputs, outputs, attrs=None):
        res = run_op(type, inputs, attrs,
                     out_slots=tuple(outputs.keys()) if outputs else None)
        for slot, t in res.items():
            caller = (outputs or {}).get(slot)
            if isinstance(caller, Tensor) and isinstance(t, Tensor):
                caller._value = t._value
                if _TRACE_REC is not None:
                    # the trace follows the caller's tensor identity
                    _TRACE_REC.alias(t, caller)
        return res


_tracer = Tracer()


def tracer() -> Tracer:
    return _tracer
