"""Weight-only post-training quantization over static Programs.

Counterpart of the weight-only half of ``paddle_tpu/slim/quantization.py``
(role parity: reference python/paddle/fluid/contrib/slim/quantization/
post_training_quantization.py): ``mark_weight_quant`` and
``PostTrainingWeightQuantPass``, which rewrites matmul-family ops onto
int8 or float8-e4m3 carriers with per-output-channel scales, lowered
through ``dequant_matmul`` (``ops/quant_ops.py``, the B7 kernel on the
card).  The pass edits the Program directly, as the JAX package's does.

Not in this slice of the port, each raising ``NotImplementedError`` where
a program asks for it: the stacked expert weights of ``moe_ffn`` ops
(``_quantize_moe``) and the spec inheritance of a tensor-parallel plan
(``program._tp_plan``).  Quantization-aware training and activation PTQ
(``QuantizationTransformPass``, ``PostTrainingQuantization``) wait too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..framework.passes import Pass, register_pass
from ..framework.program import Operator, Parameter, Program

# per-op marker a program can carry instead of the global flag (stamped
# by mark_weight_quant; an op attr, so it survives clone/proto round
# trips AND joins the program fingerprint -- stamping re-keys every
# executor cache automatically)
WEIGHT_QUANT_ATTR = "__weight_quant__"

# matmul-family ops eligible for the rewrite (the weight slot is "Y" for
# all three; conv stays unquantized)
_WQ_OPS = ("mul", "matmul", "matmul_v2")
# mul/matmul weights are [in, out]: per-output-channel axis 1
_WEIGHT_AXIS = {"mul": 1, "matmul": 1, "matmul_v2": 1}

# MoE expert FFNs (stacked [E, in, out] weights) quantize in place in the
# JAX package; the port refuses them until it lowers moe_ffn
_WQ_MOE_OPS = ("moe_ffn",)

# carrier / scale name suffixes by mode.  int8 keeps the JAX package's
# names; fp8 gets names of its own, so that a program rewritten for one mode
# never reads the other mode's carriers: the executor caches a rewrite per
# FLAGS_weight_quant value, and with shared names an int8 -> fp8 -> int8
# sequence in one scope would serve the cached int8 rewrite over the fp8
# carriers (which the JAX package does, ROADMAP Queue C)
_SUFFIXES = {"int8": ("@WQ", "@WQ_SCALE"),
             "fp8_e4m3": ("@WQ_FP8", "@WQ_FP8_SCALE")}


def _later(what: str):
    return NotImplementedError(
        f"{what} is not in the PyTorch port's weight quantization yet: it "
        f"comes with a later slice of the port")


def mark_weight_quant(program: Program, mode: str = "int8") -> Program:
    """Arm PostTrainingWeightQuantPass for ``program`` regardless of
    ``FLAGS_weight_quant``: stamps the mode onto every matmul-family op
    (attr -> fingerprint -> executor caches re-key)."""
    from ..ops.quant_ops import WEIGHT_QUANT_MODES

    if mode not in WEIGHT_QUANT_MODES:
        raise ValueError(
            f"unknown weight-quant mode {mode!r}; expected one of "
            f"{WEIGHT_QUANT_MODES}")
    for op in program.global_block.ops:
        if op.type in _WQ_OPS or op.type in _WQ_MOE_OPS:
            op.attrs[WEIGHT_QUANT_ATTR] = mode
    program._bump()
    return program


# The JAX package registers the pass before layer_scan (after
# sharding_propagation); of that order the port has flash_attention_fuse
# first, so the pass sits right after it.
@register_pass(before="redundant_cast_eliminate")
class PostTrainingWeightQuantPass(Pass):
    """Rewrite matmul-family weights to int8 / fp8-e4m3 carriers with
    per-output-channel scales, lowered through the dequant-fused
    ``dequant_matmul`` op (ops/quant_ops.py).

    Gated by ``FLAGS_weight_quant`` ('' off, 'int8', 'fp8_e4m3') or
    per-program by :func:`mark_weight_quant`.

    Mechanics per quantizable op (weight slot ``Y`` holding a 2D
    persistable var, resolved through at most one AMP ``cast``):

    - the live scope value is quantized ONCE (``quantize_weight``:
      symmetric per-output-channel, scales clamped per channel) into two
      new persistable vars ``<w>@WQ`` (carrier) and ``<w>@WQ_SCALE``
      (float32 ``[out_channels]``; ``<w>@WQ_FP8`` and
      ``<w>@WQ_FP8_SCALE`` in fp8 mode), made on the scope tensor's own
      device;
    - the op is replaced by ``dequant_matmul`` carrying the original
      semantics (``orig_type`` + the flattening/transpose attrs);
    - a weight consumed through an AMP cast is rewritten to consume the
      dequant output directly (the dequant lands at X's dtype, so
      numerics match the cast path) -- the orphaned cast is then
      DeadOpElimination's.

    The ORIGINAL float weight stays in the block and scope (checkpoints
    and further training still see it); the rewritten program simply
    never reads it.
    """

    name = "post_training_weight_quant"

    def __init__(self, mode: Optional[str] = None):
        self._mode_override = mode

    def _mode(self, program) -> Optional[str]:
        if self._mode_override:
            return self._mode_override
        for op in program.global_block.ops:
            m = op.attr(WEIGHT_QUANT_ATTR)
            if m:
                return str(m)
        from ..framework import flags

        return str(flags.flag("weight_quant")) or None

    def should_apply(self, program, ctx) -> bool:
        if ctx.scope is None or self._mode(program) is None:
            return False
        return any(op.type in _WQ_OPS or op.type in _WQ_MOE_OPS
                   for op in program.global_block.ops)

    @staticmethod
    def _resolve_weight(block, ops, idx, name):
        """Resolve op input ``name`` to a persistable 2D weight var:
        either directly, or through ONE dtype cast of one (the AMP
        pattern).  Returns (weight_name, var) or (None, None)."""

        def _weight_var(n):
            v = block._find_var_recursive(n)
            if v is not None and (isinstance(v, Parameter)
                                  or getattr(v, "persistable", False)) \
                    and len(getattr(v, "shape", ())) == 2:
                return v
            return None

        v = _weight_var(name)
        if v is not None:
            return name, v
        for j in range(idx - 1, -1, -1):
            op = ops[j]
            if name in op.output_arg_names():
                if op.type != "cast":
                    return None, None
                xs = op.inputs.get("X", [])
                if len(xs) != 1:
                    return None, None
                v = _weight_var(xs[0])
                return (xs[0], v) if v is not None else (None, None)
        return None, None

    def apply(self, program, ctx) -> bool:
        from ..monitor import stat_add
        from ..ops.quant_ops import quantize_weight, resolve_quant_mode

        block = program.global_block
        if any(op.type in _WQ_MOE_OPS for op in block.ops):
            raise _later("quantizing moe_ffn expert weights")
        if getattr(program, "_tp_plan", None) is not None:
            raise _later("a tensor-parallel plan's specs for quantized "
                         "weights")
        mode = resolve_quant_mode(self._mode(program))
        scope = ctx.scope
        quantized: Dict[str, Tuple[str, str]] = {}
        n_rewritten = n_skipped = 0
        for i, op in enumerate(list(block.ops)):
            if op.type not in _WQ_OPS:
                continue
            ys = op.input("Y")
            if len(ys) != 1:
                n_skipped += 1
                continue
            if op.type != "mul" and bool(
                    op.attr("transpose_Y", op.attr("trans_y", False))):
                n_skipped += 1  # transposed weights flip the channel
                continue        # axis; stay on the unquantized path
            if op.type == "mul" and int(op.attr("y_num_col_dims", 1)) != 1:
                n_skipped += 1
                continue
            wname, wvar = self._resolve_weight(block, block.ops, i, ys[0])
            if wname is None or not scope.has_var(wname):
                n_skipped += 1
                continue
            axis = _WEIGHT_AXIS[op.type]
            cached = quantized.get(wname)
            if cached is None:
                carrier, scale = (wname + sfx for sfx in _SUFFIXES[mode])
                q, s = quantize_weight(scope.get_var(wname), axis, mode)
                scope.set_var(carrier, q)
                scope.set_var(scale, s)
                # the IR's dtype enum has no float8 entry, so the carrier
                # is declared int8 in BOTH modes (8-bit payload either
                # way); the scope tensor -- what the executor hands the
                # op, never cast -- carries the real dtype, and the op's
                # "mode" attr records it
                block.create_var(
                    name=carrier, shape=list(wvar.shape),
                    dtype="int8", persistable=True, stop_gradient=True)
                block.create_var(
                    name=scale, shape=[int(wvar.shape[axis])],
                    dtype="float32", persistable=True,
                    stop_gradient=True)
                quantized[wname] = cached = (carrier, scale)
            carrier, scale = cached
            attrs = {
                "orig_type": op.type,
                "weight_axis": axis,
                "mode": mode,
                "bit_length": 8,
            }
            for k in ("x_num_col_dims", "y_num_col_dims", "transpose_X",
                      "transpose_Y", "trans_x", "trans_y", "alpha",
                      WEIGHT_QUANT_ATTR):
                if op.has_attr(k):
                    attrs[k] = op.attr(k)
            new_op = Operator(
                block, "dequant_matmul",
                inputs={"X": op.input("X"), "Y": [carrier],
                        "Scale": [scale]},
                outputs={k: list(v) for k, v in op.outputs.items()},
                attrs=attrs)
            block.ops[i] = new_op
            n_rewritten += 1
        if not n_rewritten:
            return False
        program._bump()
        stat_add("pass_weight_quant_ops", n_rewritten)
        if n_skipped:
            stat_add("pass_weight_quant_skipped", n_skipped)
        return True
