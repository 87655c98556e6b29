"""Quantization passes over static Programs.

Counterpart of ``paddle_tpu/slim/quantization.py`` (role parity:
reference python/paddle/fluid/contrib/slim/quantization/
quantization_pass.py:216 and post_training_quantization.py:120):

- ``QuantizationTransformPass`` / ``quant_aware``: quantization-aware
  training.  Fake quant-dequant ops (``ops/quant_ops.py``) go in front of
  the weights and activations of every quantizable op; the weights'
  are recomputed from the live weight each step, the activations' keep
  persistable moving-average scale/state/accum vars, which the captured
  step updates in place.  Apply it BEFORE ``minimize``: the qdq ops carry
  a straight-through estimator, so the backward trains through the
  quantized graph.  ``Program.clone(for_test=True)`` sets the ops'
  ``is_test``, which freezes the scales for export.
- ``PostTrainingQuantization``: activation PTQ.  The program runs over
  calibration batches, the abs-max of every quantizable-op input is
  recorded, and a clone gets qdq ops with those scales baked in
  (``fill_constant`` + moving-average qdq in ``is_test`` mode).  The
  port takes each batch's abs-max on the device and copies back one
  float an activation, where the JAX package fetches every activation to
  the host: the value is the same.
- ``mark_weight_quant`` and ``PostTrainingWeightQuantPass``: weight-only
  post-training quantization, which rewrites matmul-family ops onto int8
  or float8-e4m3 carriers with per-output-channel scales, lowered through
  ``dequant_matmul`` (``ops/quant_ops.py``, the B7 kernel on the card),
  and quantizes a ``moe_ffn`` op's stacked expert weights in place
  (per-expert ``[E, out]`` scales riding its ``W1Scale``/``W2Scale``
  slots).

Every pass edits the Program directly, as the JAX package's do.  The spec
inheritance of a tensor-parallel plan (``program._tp_plan``) raises
``NotImplementedError``: the port runs one card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..framework import unique_name
from ..framework.passes import Pass, register_pass
from ..framework.program import Operator, Parameter, Program
from ..initializer import ConstantInitializer

# op type -> input slots eligible for quantization (weights + activations)
_QUANT_SLOTS: Dict[str, Sequence[str]] = {
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
    "conv2d_transpose": ("Input", "Filter"),
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
    "matmul_v2": ("X", "Y"),
}

# weight quant_axis per op type: conv filters are OIHW -> per-output-
# channel axis 0; mul/matmul weights are [in, out] -> axis 1 (reference
# quantization_pass.py channel-wise rules)
_WEIGHT_AXIS = {"conv2d": 0, "depthwise_conv2d": 0, "conv2d_transpose": 1,
                "mul": 1, "matmul": 1, "matmul_v2": 1}

SKIP_QUANT_ATTR = "skip_quant"

_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul", "matmul_v2")


def _is_weight(var) -> bool:
    return isinstance(var, Parameter) or getattr(var, "persistable", False)


def _insert_weight_qdq(block, index, name, var, out_name, scale_name,
                       weight_quantize_type, weight_bits, axis):
    """Shared weight quant-dequant emitter (used by both the QAT
    transform pass and the PTQ export so the two cannot diverge)."""
    if weight_quantize_type == "channel_wise_abs_max":
        block.create_var(name=scale_name, shape=[int(var.shape[axis])],
                         dtype="float32", stop_gradient=True)
        block._insert_op(
            index, "fake_channel_wise_quantize_dequantize_abs_max",
            inputs={"X": [name]},
            outputs={"Out": [out_name], "OutScale": [scale_name]},
            attrs={"bit_length": weight_bits, "quant_axis": axis})
    else:
        block.create_var(name=scale_name, shape=[1], dtype="float32",
                         stop_gradient=True)
        block._insert_op(
            index, "fake_quantize_dequantize_abs_max",
            inputs={"X": [name]},
            outputs={"Out": [out_name], "OutScale": [scale_name]},
            attrs={"bit_length": weight_bits})


class QuantizationTransformPass:
    """Insert fake quant-dequant ops in front of quantizable ops.

    Weights get `abs_max` or `channel_wise_abs_max` qdq (recomputed from
    the live weight every step, like the reference's weight path);
    activations get `moving_average_abs_max` qdq with persistable
    scale/state/accum accumulators, or stateless `abs_max`.  Run
    ``apply(main, startup)`` BEFORE ``minimize`` so the backward pass
    differentiates through the quantized graph.
    """

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="moving_average_abs_max",
                 weight_quantize_type="channel_wise_abs_max",
                 moving_rate=0.9, quantizable_op_type=_QUANTIZABLE):
        if activation_quantize_type not in ("abs_max",
                                            "moving_average_abs_max"):
            raise ValueError(
                f"unknown activation_quantize_type "
                f"{activation_quantize_type!r}")
        if weight_quantize_type not in ("abs_max", "channel_wise_abs_max"):
            raise ValueError(
                f"unknown weight_quantize_type {weight_quantize_type!r}")
        self.weight_bits = int(weight_bits)
        self.activation_bits = int(activation_bits)
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.moving_rate = float(moving_rate)
        self.quantizable_op_type = set(quantizable_op_type)

    def _insert_qdq(self, startup, block, index, name, is_weight,
                    weight_axis):
        """Insert one qdq op before ``index``; returns its output's
        name."""
        var = block.var(name)
        out_name = unique_name.generate(f"{name}.quant_dequant")
        block.create_var(name=out_name, shape=list(var.shape),
                         dtype=var.dtype, stop_gradient=False)
        scale_name = unique_name.generate(f"{name}.quant_scale")
        if is_weight:
            _insert_weight_qdq(block, index, name, var, out_name,
                               scale_name, self.weight_quantize_type,
                               self.weight_bits, weight_axis)
            return out_name
        if self.activation_quantize_type == "abs_max":
            block.create_var(name=scale_name, shape=[1], dtype="float32",
                             stop_gradient=True)
            block._insert_op(
                index, "fake_quantize_dequantize_abs_max",
                inputs={"X": [name]},
                outputs={"Out": [out_name], "OutScale": [scale_name]},
                attrs={"bit_length": self.activation_bits})
            return out_name
        # moving-average: persistable scale/state/accum round-tripped
        # through the op (reference quantization_pass.py:471)
        state_name = unique_name.generate(f"{name}.quant_state")
        accum_name = unique_name.generate(f"{name}.quant_accum")
        sb = startup.global_block
        for nm in (scale_name, state_name, accum_name):
            block.create_var(name=nm, shape=[1], dtype="float32",
                             persistable=True, stop_gradient=True)
            ConstantInitializer(1.0)(sb.create_var(
                name=nm, shape=[1], dtype="float32", persistable=True), sb)
        block._insert_op(
            index, "fake_quantize_dequantize_moving_average_abs_max",
            inputs={"X": [name], "InScale": [scale_name],
                    "InState": [state_name], "InAccum": [accum_name]},
            outputs={"Out": [out_name], "OutScale": [scale_name],
                     "OutState": [state_name], "OutAccum": [accum_name]},
            attrs={"bit_length": self.activation_bits,
                   "moving_rate": self.moving_rate, "is_test": False})
        return out_name

    def apply(self, program: Program, startup_program: Program) -> Program:
        """In-place: rewrite ``program`` so every quantizable op consumes
        quant-dequantized inputs."""
        block = program.global_block
        # var name -> qdq output name, shared across consumers; local to
        # this apply(): carrying it across programs would rename vars to
        # qdq outputs that only exist in the earlier program
        dequantized: Dict[str, str] = {}
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if (op.type not in self.quantizable_op_type
                    or op.type not in _QUANT_SLOTS
                    or op.attr(SKIP_QUANT_ATTR, False)):
                i += 1
                continue
            for slot in _QUANT_SLOTS[op.type]:
                for name in list(op.input(slot)):
                    if name in dequantized:
                        op._rename_input(name, dequantized[name])
                        continue
                    var = block._find_var_recursive(name)
                    if var is None:
                        continue
                    new_name = self._insert_qdq(
                        startup_program, block, i, name, _is_weight(var),
                        _WEIGHT_AXIS.get(op.type, 0))
                    i += 1
                    dequantized[name] = new_name
                    op._rename_input(name, new_name)
            i += 1
        program._bump()
        return program


def quant_aware(program: Program, startup_program: Program,
                config: Optional[dict] = None) -> Program:
    """One-call QAT entry (reference paddleslim.quant.quant_aware)."""
    cfg = dict(config or {})
    return QuantizationTransformPass(**cfg).apply(program, startup_program)


class PostTrainingQuantization:
    """Calibrate activation scales over sample data, then emit a
    quantized inference program with FIXED scales baked in.

    Reference post_training_quantization.py:120: runs the model over
    calibration batches, records the abs-max of every quantizable-op
    input, then inserts quant/dequant with the collected scales.  The
    emitted program uses moving-average qdq ops in is_test mode so the
    stored scale is authoritative.
    """

    def __init__(self, executor, program: Program, feed_list: List[str],
                 fetch_list: List, data_loader=None, scope=None,
                 batch_nums: Optional[int] = None,
                 weight_bits=8, activation_bits=8,
                 weight_quantize_type="channel_wise_abs_max",
                 quantizable_op_type=_QUANTIZABLE):
        self._exe = executor
        self._program = program
        self._feed_list = list(feed_list)
        self._fetch_list = list(fetch_list)
        self._loader = data_loader
        self._scope = scope
        self._batch_nums = batch_nums
        self.weight_bits = int(weight_bits)
        self.activation_bits = int(activation_bits)
        self.weight_quantize_type = weight_quantize_type
        self.quantizable_op_type = set(quantizable_op_type)
        self._act_scales: Dict[str, float] = {}

    def _activation_names(self) -> List[str]:
        block = self._program.global_block
        names, seen = [], set()
        for op in block.ops:
            if op.type not in self.quantizable_op_type or \
                    op.type not in _QUANT_SLOTS:
                continue
            for slot in _QUANT_SLOTS[op.type]:
                for name in op.input(slot):
                    var = block._find_var_recursive(name)
                    if var is None or _is_weight(var):
                        continue
                    if name not in seen:
                        seen.add(name)
                        names.append(name)
        return names

    def quantize(self) -> Program:
        if self._loader is None:
            raise ValueError("PostTrainingQuantization needs a data_loader "
                             "of calibration batches")
        act_names = self._activation_names()
        maxes = {n: 0.0 for n in act_names}
        n_done = 0
        for batch in self._loader:
            if isinstance(batch, (list, tuple)):
                feed = dict(zip(self._feed_list, batch))
            else:
                feed = dict(batch)
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=act_names, scope=self._scope,
                                 return_numpy=False)
            # one float an activation crosses to the host
            amax = torch.stack([torch.amax(torch.abs(v)).float()
                                for v in outs]).cpu().tolist()
            for name, val in zip(act_names, amax):
                maxes[name] = max(maxes[name], val)
            n_done += 1
            if self._batch_nums and n_done >= self._batch_nums:
                break
        if n_done == 0:
            raise ValueError("calibration data_loader yielded no batches")
        self._act_scales = {n: max(v, 1e-8) for n, v in maxes.items()}
        return self._emit_quantized_program()

    def _emit_quantized_program(self) -> Program:
        """Clone the program and insert qdq with the calibrated scales:
        weights use live abs-max qdq (bit-exact with the QAT export);
        activations use moving-average qdq in is_test mode whose InScale
        is a constant initialized to the calibrated value."""
        prog = self._program.clone(for_test=True)
        block = prog.global_block
        dequantized: Dict[str, str] = {}
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if (op.type not in self.quantizable_op_type
                    or op.type not in _QUANT_SLOTS):
                i += 1
                continue
            for slot in _QUANT_SLOTS[op.type]:
                for name in list(op.input(slot)):
                    if name in dequantized:
                        op._rename_input(name, dequantized[name])
                        continue
                    var = block._find_var_recursive(name)
                    if var is None:
                        continue
                    is_weight = _is_weight(var)
                    if not is_weight and name not in self._act_scales:
                        continue
                    out_name = unique_name.generate(f"{name}.ptq_dequant")
                    block.create_var(name=out_name, shape=list(var.shape),
                                     dtype=var.dtype)
                    scale_name = unique_name.generate(f"{name}.ptq_scale")
                    if is_weight:
                        _insert_weight_qdq(
                            block, i, name, var, out_name, scale_name,
                            self.weight_quantize_type, self.weight_bits,
                            _WEIGHT_AXIS.get(op.type, 0))
                        i += 1
                    else:
                        # constant calibrated scale, materialized in-graph
                        block.create_var(name=scale_name, shape=[1],
                                         dtype="float32")
                        block._insert_op(
                            i, "fill_constant", inputs={},
                            outputs={"Out": [scale_name]},
                            attrs={"shape": [1], "dtype": 1,  # DT_FP32
                                   "value": float(
                                       self._act_scales[name])})
                        block._insert_op(
                            i + 1,
                            "fake_quantize_dequantize_moving_average_abs"
                            "_max",
                            inputs={"X": [name], "InScale": [scale_name]},
                            outputs={"Out": [out_name]},
                            attrs={"bit_length": self.activation_bits,
                                   "is_test": True})
                        i += 2
                    dequantized[name] = out_name
                    op._rename_input(name, out_name)
            i += 1
        prog._bump()
        return prog


# ---------------------------------------------------------------------------
# post-training weight-only quantization (the inference byte-shrinker)
# ---------------------------------------------------------------------------

# per-op marker a program can carry instead of the global flag (stamped
# by mark_weight_quant; an op attr, so it survives clone/proto round
# trips AND joins the program fingerprint -- stamping re-keys every
# executor cache automatically)
WEIGHT_QUANT_ATTR = "__weight_quant__"

# matmul-family ops eligible for the rewrite (the weight slot is "Y" for
# all three; conv stays unquantized)
_WQ_OPS = ("mul", "matmul", "matmul_v2")

# MoE expert FFNs quantize IN PLACE: the stacked [E, in, out] weights
# become carriers + per-expert [E, out] scales riding new W1Scale/W2Scale
# input slots that the moe_ffn lowering dequantizes before the expert
# products (ops/moe_ops.py _dequant_stacked) -- no op replacement, so the
# router and combine are untouched
_WQ_MOE_OPS = ("moe_ffn",)
_WQ_MOE_SLOTS = ("W1", "W2")  # output-channel axis 2 for both

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


def _declare_carrier(block, carrier, scale, wvar, scale_shape):
    """The carrier and scale vars of a quantized weight.  The IR's dtype
    enum has no float8 entry, so the carrier is declared int8 in BOTH
    modes (8-bit payload either way); the scope tensor -- what the
    executor hands the op, never cast -- carries the real dtype, and the
    op's "mode" attr records it."""
    block.create_var(name=carrier, shape=list(wvar.shape), dtype="int8",
                     persistable=True, stop_gradient=True)
    block.create_var(name=scale, shape=list(scale_shape), dtype="float32",
                     persistable=True, stop_gradient=True)


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


# Registered before layer_scan, as in the JAX package: the quantized
# carriers and scales are per-layer state the scan then stacks.
@register_pass(before="layer_scan")
class PostTrainingWeightQuantPass(Pass):
    """Rewrite matmul-family weights to int8 / fp8-e4m3 carriers with
    per-output-channel scales, lowered through the dequant-fused
    ``dequant_matmul`` op (ops/quant_ops.py).

    Gated by ``FLAGS_weight_quant`` ('' off, 'int8', 'fp8_e4m3') or
    per-program by :func:`mark_weight_quant`.

    A ``moe_ffn`` op keeps its type: its stacked ``W1``/``W2`` become
    carriers (``quantize_weight_stacked``, per-expert ``[E, out]``
    scales) on the op's ``W1``/``W2`` slots, the scales on new
    ``W1Scale``/``W2Scale`` slots, and the op gets a ``mode`` attr.

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

    def _quantize_moe(self, op, block, scope, mode,
                      quantized) -> Tuple[int, int]:
        """Quantize one moe_ffn op's stacked expert weights in place:
        W1/W2 -> carrier + per-expert [E, out] scale riding the
        W1Scale/W2Scale input slots the lowering already consumes.
        Returns (n_rewritten_slots, n_skipped_slots)."""
        from ..ops.quant_ops import quantize_weight_stacked

        n_done = n_skip = 0
        for slot in _WQ_MOE_SLOTS:
            names = op.input(slot)
            if len(names) != 1:
                n_skip += 1
                continue
            wname = names[0]
            wvar = block._find_var_recursive(wname)
            if wvar is None or len(getattr(wvar, "shape", ())) != 3 \
                    or not _is_weight(wvar) or not scope.has_var(wname):
                n_skip += 1
                continue
            axis = 2  # [E, in, out] for W1 and W2 alike
            cached = quantized.get(wname)
            if cached is None:
                carrier, scale = (wname + sfx for sfx in _SUFFIXES[mode])
                q, s = quantize_weight_stacked(scope.get_var(wname), axis,
                                               mode)
                scope.set_var(carrier, q)
                scope.set_var(scale, s)
                _declare_carrier(block, carrier, scale, wvar,
                                 [int(wvar.shape[0]), int(wvar.shape[axis])])
                quantized[wname] = cached = (carrier, scale)
            carrier, scale = cached
            op.inputs[slot] = [carrier]
            op.inputs[slot + "Scale"] = [scale]
            n_done += 1
        if n_done:
            op.attrs["mode"] = mode
        return n_done, n_skip

    def apply(self, program, ctx) -> bool:
        from ..monitor import stat_add
        from ..ops.quant_ops import quantize_weight, resolve_quant_mode

        block = program.global_block
        if getattr(program, "_tp_plan", None) is not None:
            raise _later("a tensor-parallel plan's specs for quantized "
                         "weights")
        mode = resolve_quant_mode(self._mode(program))
        scope = ctx.scope
        quantized: Dict[str, Tuple[str, str]] = {}
        n_rewritten = n_skipped = 0
        for i, op in enumerate(list(block.ops)):
            if op.type in _WQ_MOE_OPS:
                nd, ns = self._quantize_moe(op, block, scope, mode,
                                            quantized)
                n_rewritten += nd
                n_skipped += ns
                continue
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
                _declare_carrier(block, carrier, scale, wvar,
                                 [int(wvar.shape[axis])])
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
