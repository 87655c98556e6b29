"""Static-graph AMP: program rewrite + loss scaling.

Copy of ``paddle_tpu/amp/static_amp.py`` (the JAX package's
module imports no JAX); the program it builds is the same, op for op.

Role parity: reference fluid/contrib/mixed_precision/decorator.py:235
(`decorate` -> OptimizerWithMixedPrecision) and fp16_utils.py:193
(`rewrite_program` inserting casts per white/black lists), with the
dynamic loss-scale state machine as ops (operators/amp/).

TPU-native default is bf16: same exponent range as fp32, so the loss
scaling machinery is skipped entirely (`use_bf16=True`) — white-list ops
just run with bf16 inputs and XLA keeps MXU accumulation in fp32.
"""
from __future__ import annotations

from ..framework import dtypes, unique_name
from ..framework.program import GRAD_SUFFIX
from .lists import AutoMixedPrecisionLists

_FLOAT = dtypes.to_enum("float32")


def _cast_slot(block, op_idx, op, slot, names_to_cast, dest_dtype, cache):
    """Insert cast ops before `op` for the given input names; returns the
    number of ops inserted."""
    inserted = 0
    slot_names = op.inputs[slot]
    for i, name in enumerate(list(slot_names)):
        if name not in names_to_cast:
            continue
        key = (name, dest_dtype)
        if key not in cache:
            # NOT stop_gradient: casts sit on the differentiable path and
            # must pass gradients through to the fp32 master params
            out = block.create_var(
                name=unique_name.generate(name + ".cast"),
                dtype=dest_dtype, stop_gradient=False)
            from ..framework.program import Operator

            cast_op = Operator(block, "cast", {"X": [name]}, {"Out": [out.name]},
                               {"out_dtype": dest_dtype})
            block.ops.insert(op_idx + inserted, cast_op)
            inserted += 1
            cache[key] = out.name
        slot_names[i] = cache[key]
    return inserted


def rewrite_program(main_program, amp_lists: AutoMixedPrecisionLists,
                    dest_dtype="float16"):
    """Walk ops: white-list ops get their float inputs cast to dest_dtype;
    black-list ops get them cast back to fp32 (reference fp16_utils.py:193)."""
    block = main_program.global_block
    dest_enum = dtypes.to_enum(dest_dtype)
    float_vars = set()
    for var in block.vars.values():
        if var.dtype == _FLOAT:
            float_vars.add(var.name)

    i = 0
    low_vars = set()  # names currently known to be dest_dtype
    while i < len(block.ops):
        op = block.ops[i]
        cache = {}
        if op.type in amp_lists.white_list:
            ins = 0
            for slot, names in list(op.inputs.items()):
                to_cast = {n for n in names
                           if n in float_vars and n not in low_vars
                           and n not in amp_lists.black_varnames}
                if to_cast:
                    ins += _cast_slot(block, i, op, slot,
                                      to_cast, dest_enum, cache)
            low_vars.update(op.output_arg_names())
            i += ins + 1
        elif op.type in amp_lists.black_list:
            ins = 0
            for slot, names in list(op.inputs.items()):
                to_cast = {n for n in names if n in low_vars}
                if to_cast:
                    ins += _cast_slot(block, i, op, slot,
                                      to_cast, _FLOAT, cache)
            i += ins + 1
        else:
            # gray: propagate low precision through; for pure-compute
            # elementwise ops also cast any remaining fp32 inputs down so
            # jnp promotion cannot lift the chain back to fp32 (reference
            # fp16_utils.py:193 gray handling) — bias adds and residual
            # adds are the load-bearing cases
            ins = 0
            if any(n in low_vars for n in op.input_arg_names()):
                if op.type in getattr(amp_lists, "gray_follow_cast", ()):
                    for slot, names in list(op.inputs.items()):
                        to_cast = {n for n in names
                                   if n in float_vars and n not in low_vars
                                   and n not in amp_lists.black_varnames}
                        if to_cast:
                            ins += _cast_slot(block, i, op, slot,
                                              to_cast, dest_enum, cache)
                low_vars.update(op.output_arg_names())
            i += ins + 1
    main_program._bump()
    return main_program


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
                 use_dynamic_loss_scaling=True, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
                 use_bf16=True):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = init_loss_scaling
        self._dynamic = use_dynamic_loss_scaling
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._use_bf16 = use_bf16
        self._loss_scaling = None

    def _create_scale_state(self, block, startup):
        from ..initializer import ConstantInitializer

        def make(name, value, dtype="float32"):
            v = block.create_var(name=unique_name.generate(name), shape=[1],
                                 dtype=dtype, persistable=True,
                                 stop_gradient=True)
            sb = startup.global_block
            sv = sb.create_var(name=v.name, shape=[1], dtype=dtype,
                               persistable=True)
            ConstantInitializer(value)(sv, sb)
            return v

        self._loss_scaling = make("loss_scaling", self._init_loss_scaling)
        self._good_steps = make("good_steps", 0, "int32")
        self._bad_steps = make("bad_steps", 0, "int32")

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..framework.program import default_startup_program

        program = loss.block.program
        dest = "bfloat16" if self._use_bf16 else "float16"
        if not self._use_bf16:
            # the norms' bf16-transparent treatment (fp32 stats inside,
            # low-precision Y) is only safe with bf16's fp32 exponent
            # range; under fp16 + loss scaling keep them fp32 islands as
            # the reference does (fp16_lists.py)
            import copy

            lists = copy.deepcopy(self._amp_lists)
            lists.black_list |= {"batch_norm", "sync_batch_norm",
                                 "layer_norm", "softmax"} - lists.white_list
            self._amp_lists = lists
        rewrite_program(program, self._amp_lists, dest)

        if self._use_bf16:
            # bf16 keeps fp32 range: no loss scaling needed (TPU-native)
            return self._optimizer.minimize(loss, startup_program,
                                            parameter_list, no_grad_set)

        startup = startup_program or default_startup_program()
        block = program.global_block
        self._create_scale_state(block, startup)
        scaled_loss = block.create_var(
            name=unique_name.generate(loss.name + ".scaled"),
            shape=list(loss.shape) or [1],
            dtype="float32", stop_gradient=False)
        block.append_op("elementwise_mul",
                        {"X": [loss.name], "Y": [self._loss_scaling.name]},
                        {"Out": [scaled_loss.name]}, {"axis": -1})

        def unscale_and_update(params_grads):
            grad_names = [g.name if hasattr(g, "name") else g
                          for _, g in params_grads]
            found_inf = block.create_var(
                name=unique_name.generate("found_inf"), dtype="bool",
                stop_gradient=True)
            block.append_op(
                "check_finite_and_unscale",
                {"X": grad_names, "Scale": self._loss_scaling.name},
                {"Out": grad_names, "FoundInfinite": found_inf.name})
            if self._dynamic:
                block.append_op(
                    "update_loss_scaling",
                    {"X": grad_names, "FoundInfinite": found_inf.name,
                     "PrevLossScaling": self._loss_scaling.name,
                     "InGoodSteps": self._good_steps.name,
                     "InBadSteps": self._bad_steps.name},
                    {"Out": grad_names,
                     "LossScaling": self._loss_scaling.name,
                     "OutGoodSteps": self._good_steps.name,
                     "OutBadSteps": self._bad_steps.name},
                    {"incr_every_n_steps": self._incr_every,
                     "decr_every_n_nan_or_inf": self._decr_every,
                     "incr_ratio": self._incr_ratio,
                     "decr_ratio": self._decr_ratio})
            return params_grads

        if getattr(self._optimizer, "supports_grad_transform", False):
            # gradient_merge composition: the merge optimizer drives
            # backward/apply itself, so the unscale + scaling-state
            # update ride its grad-transform hook — they land inside the
            # masked region, and the merge machinery select-restores the
            # loss-scaling counters on non-update steps (otherwise the
            # masked zero-grads would count as "good steps" every step)
            return self._optimizer.minimize(
                scaled_loss, startup, parameter_list, no_grad_set,
                grad_transform=unscale_and_update)

        params_grads = self._optimizer.backward(
            scaled_loss, startup, parameter_list, no_grad_set)
        unscale_and_update(params_grads)
        opt_ops = self._optimizer.apply_gradients(params_grads)
        return opt_ops, params_grads

    def backward(self, *args, **kwargs):
        return self._optimizer.backward(*args, **kwargs)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def __getattr__(self, name):
        if name == "_optimizer":  # not yet set (unpickling/deepcopy)
            raise AttributeError(name)
        return getattr(self._optimizer, name)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5, use_dynamic_loss_scaling=True,
             use_bf16=None, use_pure_fp16=False, use_fp16_guard=None):
    """Reference fluid.contrib.mixed_precision.decorate.  On TPU the
    default low precision is bf16 (no loss scaling); pass use_bf16=False
    for fp16 + dynamic scaling parity."""
    if use_bf16 is None:
        use_bf16 = True
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        use_bf16=use_bf16)
