"""Model statistics: parameter counts and FLOPs.

Counterpart of ``paddle_tpu/hapi/model_stat.py`` (reference
python/paddle/hapi, paddle.summary / paddle.flops backed by
fluid/contrib/model_stat.py).  Stats come from a static Program walk, the
op stream the executor runs, so a whole train program's count includes
its backward ops.  ``flops(layer, input_size)`` and ``summary(layer,
input_size=...)`` trace a dygraph Layer into a program through
``dygraph.jit``, which comes with ROADMAP Queue A item 6: they raise
``NotImplementedError`` naming it.  ``flops(program)``,
``program_flops``, ``memory_usage`` and ``summary(layer)`` work.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _prod(xs):
    out = 1
    for x in xs:
        # dynamic (-1) dims count as 1: a static-graph program with a
        # symbolic batch reports per-sample FLOPs (traced programs have
        # concrete batch dims, so paddle.flops(net, input_size) is exact)
        out *= max(int(x), 1)
    return out


def _shape_of(block, name):
    """``block`` is a ``_Shapes`` view (``program_flops``) or a Block."""
    if isinstance(block, _Shapes):
        return block(name)
    v = block._find_var_recursive(name)
    return list(v.shape) if v is not None and v.shape else []


# ops whose first output has the shape of their X (or Input) input
_SAME_SHAPE = {"batch_norm", "sync_batch_norm", "layer_norm", "dropout",
               "relu", "relu6", "sigmoid", "tanh", "gelu", "scale", "cast",
               "clip", "softmax", "leaky_relu", "hard_swish", "hard_sigmoid",
               "swish", "elu", "sqrt", "square", "exp", "abs", "assign"}


def _window(size, k, stride, pad_lo, pad_hi, dilation=1):
    if size < 0:
        return -1
    return (size + pad_lo + pad_hi - (dilation * (k - 1) + 1)) // stride + 1


def _pads(op, n=2):
    """(lo, hi) paddings per spatial dim from a 2- or 4-element attr."""
    p = list(op.attr("paddings", [0] * n))
    return [(p[i], p[i]) for i in range(n)] if len(p) == n else \
        [(p[2 * i], p[2 * i + 1]) for i in range(n)]


class _Shapes:
    """Var shapes of a block: the declared one where a var has it, else
    inferred op by op.  The 2.0 functional API's static ops (``op_call``)
    make their outputs without a shape, so without this the FLOPs of a
    program built through ``nn`` layers (the hapi static adapter's) would
    miss every convolution and matmul; the JAX package's ``program_flops``
    prices none of them there."""

    def __init__(self, block):
        self.block = block
        self.inferred = {}
        for op in block.ops:
            try:
                self._infer(op)
            except (KeyError, IndexError, TypeError, ValueError):
                pass  # an op with no rule or odd attrs: its outputs stay unknown

    def __call__(self, name):
        v = self.block._find_var_recursive(name)
        if v is not None and v.shape:
            return list(v.shape)
        return list(self.inferred.get(name, []))

    def _set(self, op, slot, shape):
        outs = op.output(slot)
        if outs and shape and not self(outs[0]):
            self.inferred[outs[0]] = [int(d) for d in shape]

    def _infer(self, op):
        t = op.type
        if t in _SAME_SHAPE:
            src = op.input("X") or op.input("Input")
            self._set(op, "Y" if "norm" in t else "Out", self(src[0]))
        elif t in ("conv2d", "depthwise_conv2d"):
            n, _, h, w = self(op.input("Input")[0])
            o, _, kh, kw = self(op.input("Filter")[0])
            s, d = op.attr("strides", [1, 1]), op.attr("dilations", [1, 1])
            alg = op.attr("padding_algorithm", "EXPLICIT")
            if alg == "SAME":
                hw = [-(-h // s[0]), -(-w // s[1])]
            else:
                pads = [(0, 0), (0, 0)] if alg == "VALID" else _pads(op)
                hw = [_window(x, k, st, lo, hi, dl) for x, k, st, (lo, hi), dl
                      in zip((h, w), (kh, kw), s, pads, d)]
            self._set(op, "Output", [n, o] + hw)
        elif t == "pool2d":
            n, c, h, w = self(op.input("X")[0])
            k = list(op.attr("ksize", [1, 1]))
            if op.attr("global_pooling", False):
                hw = [1, 1]
            elif op.attr("adaptive", False):
                hw = k
            else:
                hw = [_window(x, kk, st, lo, hi) for x, kk, st, (lo, hi)
                      in zip((h, w), k, op.attr("strides", k), _pads(op))]
            self._set(op, "Out", [n, c] + hw)
        elif t.startswith("elementwise_"):
            x, y = self(op.input("X")[0]), self(op.input("Y")[0])
            self._set(op, "Out", x if len(x) >= len(y) else y)
        elif t == "flatten_contiguous_range":
            x = self(op.input("X")[0])
            a, b = op.attr("start_axis", 1), op.attr("stop_axis", -1)
            a, b = a % len(x), b % len(x)
            mid = x[a:b + 1]
            flat = -1 if any(d < 0 for d in mid) else _prod(mid)
            self._set(op, "Out", x[:a] + [flat] + x[b + 1:])
        elif t in ("matmul", "matmul_v2"):
            x, y = self(op.input("X")[0]), self(op.input("Y")[0])
            if op.attr("trans_x", op.attr("transpose_X", False)):
                x = x[:-2] + [x[-1], x[-2]]
            if op.attr("trans_y", op.attr("transpose_Y", False)):
                y = y[:-2] + [y[-1], y[-2]]
            self._set(op, "Out", x[:-1] + [y[-1]])
        elif t == "mul":
            x, y = self(op.input("X")[0]), self(op.input("Y")[0])
            self._set(op, "Out", x[:op.attr("x_num_col_dims", 1)]
                      + y[op.attr("y_num_col_dims", 1):])


def _conv_flops(block, op):
    out = _shape_of(block, op.output("Output")[0])
    w = _shape_of(block, op.input("Filter")[0])
    if len(out) < 3 or not w:
        return 0
    if op.type == "conv2d_transpose":
        # filter is (Cin, Cout/groups, kh, kw): each INPUT element
        # scatters into Cout/g*kh*kw outputs — MACs = in_elems*prod(w[1:])
        inp = _shape_of(block, op.input("Input")[0])
        return 2 * _prod(inp) * _prod(w[1:])
    # forward conv filter is (Cout, Cin/groups, kh, kw): w[1:] is the
    # per-output fan-in.  MACs = out_elems * prod(w[1:]); FLOPs = 2*MACs
    return 2 * _prod(out) * _prod(w[1:])


def _matmul_flops(block, op):
    x = _shape_of(block, op.input("X")[0])
    y = _shape_of(block, op.input("Y")[0])
    out_slot = "Out"
    out = _shape_of(block, op.output(out_slot)[0])
    if not x or not y:
        return 0
    k = x[-1] if not bool(op.attr("transpose_X",
                                  op.attr("trans_x", False))) else x[-2]
    return 2 * _prod(out) * int(k) if out else 0


def _flash_attention_flops(block, op):
    """Model FLOPs of the fused attention op: the two score/context
    contractions it replaced (2*MACs each over B*H*Sq*Sk*D).  The
    backward's tile recompute is an implementation cost, not model
    work, so — like activation recompute under remat — it is NOT
    priced; this keeps MFU comparable across FLAGS_flash_attention
    settings at identical config."""
    q = _shape_of(block, op.input("Q")[0])
    k = _shape_of(block, op.input("K")[0])
    if len(q) != 4 or len(k) != 4:
        return 0
    b, h, sq, d = q
    sk = k[2]
    return 4 * _prod([b, h, sq, sk, d])


_ELEMENTWISE = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min", "relu",
    "sigmoid", "tanh", "gelu", "scale", "softmax", "cast", "clip",
}

_GRAD_CONV = {"conv2d_grad", "depthwise_conv2d_grad",
              "conv2d_transpose_grad"}
_GRAD_MATMUL = {"matmul_grad", "matmul_v2_grad", "mul_grad"}


class _FwdSlotView:
    """Grad ops carry the forward op's full slots in their INPUTS
    (backward.default_grad_maker copies them); this shim re-views a
    grad op through the forward slot names so the forward estimators
    can price the backward work.  A matmul/conv backward is two
    forward-sized contractions (dX and dY/dFilter), hence the 2x in
    ``program_flops``."""

    __slots__ = ("_op", "type")

    def __init__(self, op):
        self._op = op
        self.type = op.attr("__fwd_type__", None) or op.type[:-len("_grad")]

    def input(self, slot):
        return self._op.inputs.get(slot, [])

    def output(self, slot):  # fwd outputs live in the grad op's inputs
        return self._op.inputs.get(slot, [])

    def attr(self, name, default=None):
        return self._op.attr(name, default)


def program_flops(program, detail=False):
    """FLOPs of one execution of ``program``'s global block.

    Matmuls/convs count 2*MACs and their ``_grad``
    siblings 2x that (dX + dW are forward-sized contractions, priced
    through the forward slots the grad maker copies); elementwise ops
    count one FLOP per output element; everything else is
    free (layout, control, IO).  Returns total FLOPs, plus a
    per-op-type breakdown when ``detail=True``."""
    block = _Shapes(program.global_block)
    per_type: Dict[str, int] = {}
    for op in block.block.ops:
        if op.type in ("conv2d", "depthwise_conv2d", "conv2d_transpose"):
            f = _conv_flops(block, op)
        elif op.type in ("matmul", "matmul_v2", "mul"):
            f = _matmul_flops(block, op)
        elif op.type == "flash_attention":
            f = _flash_attention_flops(block, op)
        elif op.type == "flash_attention_grad":
            # dQ/dK + dV/dP: four forward-sized contractions vs the
            # forward's two — same 2x convention as matmul_grad
            try:
                f = 2 * _flash_attention_flops(block, _FwdSlotView(op))
            except (IndexError, KeyError):
                f = 0
        elif op.type in _GRAD_CONV or op.type in _GRAD_MATMUL:
            # backward = dX + dW, each a forward-sized contraction
            est = _conv_flops if op.type in _GRAD_CONV else _matmul_flops
            try:
                f = 2 * est(block, _FwdSlotView(op))
            except (IndexError, KeyError):  # hand-built grad op missing
                f = 0                       # the forward slots: skip
        elif op.type in _ELEMENTWISE:
            outs = op.output_arg_names()
            f = _prod(_shape_of(block, outs[0])) if outs else 0
        else:
            f = 0
        if f:
            per_type[op.type] = per_type.get(op.type, 0) + f
    total = sum(per_type.values())
    if detail:
        return total, dict(sorted(per_type.items(),
                                  key=lambda kv: -kv[1]))
    return total


_DTYPE_BYTES = {"float32": 4, "float64": 8, "int32": 4, "int64": 8,
                "uint32": 4, "uint64": 8, "float16": 2, "bfloat16": 2,
                "int16": 2, "uint16": 2, "uint8": 1, "int8": 1,
                "bool": 1}


def memory_usage(program, batch_size=1) -> Dict[str, float]:
    """Rough per-device memory estimate for one execution (reference
    fluid/contrib/memory_usage_calc.py role).  The true peak depends on
    liveness (the executor frees each value after its last use), so this
    is the upper bound the reference computes: sum of var sizes, split
    into parameters vs activations, with -1 batch dims filled by
    ``batch_size``."""
    params = acts = 0
    for var in program.global_block.vars.values():
        shape = list(var.shape or [])
        if not shape:
            continue
        n = 1
        for s in shape:
            n *= batch_size if int(s) in (-1, 0) else int(s)
        dt = getattr(var, "dtype_str", None) or str(var.dtype)
        nbytes = n * _DTYPE_BYTES.get(str(dt), 4)
        if getattr(var, "persistable", False):
            params += nbytes
        else:
            acts += nbytes
    return {"parameter_mb": round(params / 2**20, 3),
            "activation_mb": round(acts / 2**20, 3),
            "total_mb": round((params + acts) / 2**20, 3)}


def flops(net, input_size=None, dtype="float32", print_detail=False):
    """Reference paddle.flops: FLOPs of one forward pass.

    ``net`` is an already-built static Program; a Layer (traced at
    ``input_size``) raises until ``dygraph.jit`` is ported (ROADMAP
    Queue A item 6).
    """
    from ..framework.program import Program

    if not isinstance(net, Program):
        raise NotImplementedError(
            "flops(layer, input_size) traces the Layer into a program "
            "through dygraph.jit, which comes with ROADMAP Queue A item 6 "
            "(jit / dy2static) in a later slice of the port; pass a static "
            "Program (e.g. a hapi Model's train program) instead")
    prog = net
    total, per_type = program_flops(prog, detail=True)
    if print_detail:
        print(f"Total FLOPs: {total:,}")
        for t, f in per_type.items():
            print(f"  {t:24s} {f:,}")
    return total


def summary(net, input_size=None, dtypes=None):
    """Reference paddle.summary: parameter table + totals for a Layer.
    With ``input_size`` it also prices a traced forward (``dtypes`` the
    traced input dtype), which raises until ``dygraph.jit`` is ported
    (ROADMAP Queue A item 6)."""
    out = {}
    if input_size is not None:
        dt = dtypes if isinstance(dtypes, str) else \
            (dtypes[0] if dtypes else "float32")
        out["flops"] = flops(net, input_size, dtype=dt)
    lines = [f"Model: {type(net).__name__}"]
    total = trainable = 0
    for name, p in net.named_parameters():
        n = _prod(p.shape)
        total += n
        if getattr(p, "trainable", True):
            trainable += n
        lines.append(f"  {name:40s} {str(list(p.shape)):20s} {n}")
    lines.append(f"Total params: {total}")
    lines.append(f"Trainable params: {trainable}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable, **out}
