"""Optimizers — build update ops into the main program.

Copy of ``paddle_tpu/optimizer/static_opt.py`` (the JAX package's
module imports no JAX); the program it builds is the same, op for op.

Role parity: reference python/paddle/fluid/optimizer.py (Optimizer base :57,
SGD :956, Momentum :1050, Adam :1853, Adamax :2119, Lamb :2962 ...) and
python/paddle/optimizer (AdamW).  ``minimize`` = append_backward +
regularization + grad clip + per-param update ops; the whole train step
(fwd+bwd+update) compiles to one XLA computation.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..framework import unique_name
from ..framework.backward import append_backward
from ..framework.program import (
    Program,
    Variable,
    default_main_program,
    default_startup_program,
)
from ..initializer import ConstantInitializer


class Optimizer:
    _accum_defaults: Dict[str, float] = {}

    def __init__(
        self,
        learning_rate=0.001,
        parameter_list=None,
        regularization=None,
        grad_clip=None,
        name=None,
    ):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name or unique_name.generate(type(self).__name__)
        self._lr_var: Optional[Variable] = None
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    # -- learning rate ---------------------------------------------------
    def _create_global_learning_rate(self, program=None):
        if self._lr_var is not None:
            return self._lr_var
        from ..optimizer_lr import LRScheduler

        program = program or default_main_program()
        lr_value = self._learning_rate
        if isinstance(lr_value, LRScheduler):
            lr_value._bind(self)
            init = lr_value.get_lr()
        elif isinstance(lr_value, Variable):
            self._lr_var = lr_value
            return lr_value
        else:
            init = float(lr_value)
        name = unique_name.generate("learning_rate")
        self._lr_var = program.global_block.create_var(
            name=name, shape=[1], dtype="float32", persistable=True, stop_gradient=True
        )
        sb = default_startup_program().global_block
        sv = sb.create_var(name=name, shape=[1], dtype="float32", persistable=True)
        ConstantInitializer(init)(sv, sb)
        return self._lr_var

    def set_lr(self, value: float, scope=None):
        """Host-side LR update: writes the scalar into the scope (4-byte H2D,
        no recompile — the LR var is part of the compiled step's state)."""
        import numpy as np

        from ..framework.scope import global_scope

        scope = scope or global_scope()
        if self._lr_var is not None:
            scope.set_var(self._lr_var.name, np.asarray([value], dtype="float32"))

    def get_lr(self) -> float:
        import numpy as np

        from ..framework.scope import global_scope

        if self._lr_var is None:
            lr = self._learning_rate
            return float(lr if not hasattr(lr, "get_lr") else lr.get_lr())
        try:
            return float(np.asarray(global_scope().get_var(self._lr_var.name))[0])
        except KeyError:
            return 0.0

    # -- accumulators ----------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None, dtype="float32"):
        key = name
        self._accumulators.setdefault(key, {})
        if param.name in self._accumulators[key]:
            return self._accumulators[key][param.name]
        var_name = unique_name.generate(f"{param.name}_{name}")
        shape = list(shape if shape is not None else param.shape)
        v = default_main_program().global_block.create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True, stop_gradient=True
        )
        sb = default_startup_program().global_block
        sv = sb.create_var(name=var_name, shape=shape, dtype=dtype, persistable=True)
        ConstantInitializer(fill_value)(sv, sb)
        self._accumulators[key][param.name] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- pipeline --------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        plist = parameter_list or self._parameter_list
        ckpts = getattr(loss.block.program, "_recompute_checkpoints", None)
        return append_backward(loss, parameter_list=plist,
                               no_grad_set=no_grad_set, checkpoints=ckpts)

    def apply_gradients(self, params_grads):
        params_grads = self._apply_regularization(params_grads)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._create_global_learning_rate()
        block = default_main_program().global_block
        ops = []
        self._create_accumulators(block, [p for p, _ in params_grads])
        for p, g in params_grads:
            ops.append(self._append_optimize_op(block, (p, g)))
        self._finish_update(block, params_grads)
        return ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        params_grads = self.backward(
            loss, startup_program, parameter_list or self._parameter_list, no_grad_set
        )
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    # hooks
    def _create_accumulators(self, block, params):
        pass

    def _finish_update(self, block, params_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _apply_regularization(self, params_grads):
        from ..regularizer import append_regularization_ops

        return append_regularization_ops(params_grads, self.regularization)

    # parity helper used by fleet / meta optimizers
    def _effective_lr_input(self, param):
        return self._lr_var


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "sgd",
            {"Param": p, "Grad": g, "LearningRate": self._lr_var},
            {"ParamOut": p},
        )


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            {"Param": p, "Grad": g, "Velocity": v, "LearningRate": self._lr_var},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class _AdamBase(Optimizer):
    op_type = "adam"

    def __init__(
        self,
        learning_rate=0.001,
        beta1=0.9,
        beta2=0.999,
        epsilon=1e-8,
        lazy_mode=False,
        **kw,
    ):
        super().__init__(learning_rate, **kw)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1, shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=self._beta2, shape=[1])

    def _extra_attrs(self, param):
        return {}

    def _append_optimize_op(self, block, pg):
        p, g = pg
        attrs = {
            "beta1": self._beta1,
            "beta2": self._beta2,
            "epsilon": self._epsilon,
            **self._extra_attrs(p),
        }
        return block.append_op(
            self.op_type,
            {
                "Param": p,
                "Grad": g,
                "Moment1": self._get_accumulator("moment1", p),
                "Moment2": self._get_accumulator("moment2", p),
                "Beta1Pow": self._get_accumulator("beta1_pow", p),
                "Beta2Pow": self._get_accumulator("beta2_pow", p),
                "LearningRate": self._lr_var,
            },
            {
                "ParamOut": p,
                "Moment1Out": self._get_accumulator("moment1", p),
                "Moment2Out": self._get_accumulator("moment2", p),
                "Beta1PowOut": self._get_accumulator("beta1_pow", p),
                "Beta2PowOut": self._get_accumulator("beta2_pow", p),
            },
            attrs,
        )


class AdamOptimizer(_AdamBase):
    op_type = "adam"


class AdamWOptimizer(_AdamBase):
    """Decoupled weight decay (paddle 2.0 paddle.optimizer.AdamW)."""

    op_type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, apply_decay_param_fun=None, **kw):
        super().__init__(learning_rate, **kw)
        self._weight_decay = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _extra_attrs(self, param):
        decay = self._weight_decay
        if self._apply_decay_param_fun is not None and not self._apply_decay_param_fun(param.name):
            decay = 0.0
        return {"coeff": float(decay), "with_decay": decay != 0.0}


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "adamax",
            {
                "Param": p,
                "Grad": g,
                "Moment": self._get_accumulator("moment", p),
                "InfNorm": self._get_accumulator("inf_norm", p),
                "Beta1Pow": self._get_accumulator("beta1_pow", p),
                "LearningRate": self._lr_var,
            },
            {
                "ParamOut": p,
                "MomentOut": self._get_accumulator("moment", p),
                "InfNormOut": self._get_accumulator("inf_norm", p),
            },
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
        )

    def _finish_update(self, block, params_grads):
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow", p)
            block.append_op(
                "scale", {"X": b1p}, {"Out": b1p}, {"scale": self._beta1}
            )


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_accum = initial_accumulator_value

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p, fill_value=self._init_accum)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            {"Param": p, "Grad": g, "Moment": m, "LearningRate": self._lr_var},
            {"ParamOut": p, "MomentOut": m},
            {"epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "adadelta",
            {
                "Param": p,
                "Grad": g,
                "AvgSquaredGrad": self._get_accumulator("avg_squared_grad", p),
                "AvgSquaredUpdate": self._get_accumulator("avg_squared_update", p),
            },
            {
                "ParamOut": p,
                "AvgSquaredGradOut": self._get_accumulator("avg_squared_grad", p),
                "AvgSquaredUpdateOut": self._get_accumulator("avg_squared_update", p),
            },
            {"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum, self._centered = rho, epsilon, momentum, centered

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        inputs = {
            "Param": p,
            "Grad": g,
            "MeanSquare": self._get_accumulator("mean_square", p),
            "Moment": self._get_accumulator("moment", p),
            "LearningRate": self._lr_var,
        }
        outputs = {
            "ParamOut": p,
            "MeanSquareOut": self._get_accumulator("mean_square", p),
            "MomentOut": self._get_accumulator("moment", p),
        }
        if self._centered:
            inputs["MeanGrad"] = self._get_accumulator("mean_grad", p)
            outputs["MeanGradOut"] = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop",
            inputs,
            outputs,
            {
                "decay": self._rho,
                "epsilon": self._epsilon,
                "momentum": self._momentum,
                "centered": self._centered,
            },
        )


class LambOptimizer(_AdamBase):
    op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999, epsilon=1e-6, exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2, epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _extra_attrs(self, param):
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(param):
            wd = 0.0
        return {"weight_decay": float(wd)}


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            {"Param": p, "Grad": g, "Velocity": v, "LearningRate": self._lr_var},
            {"ParamOut": p, "VelocityOut": v},
            {
                "mu": self._momentum,
                "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay,
                "epsilon": self._epsilon,
            },
        )


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "ftrl",
            {
                "Param": p,
                "Grad": g,
                "SquaredAccumulator": self._get_accumulator("squared", p),
                "LinearAccumulator": self._get_accumulator("linear", p),
                "LearningRate": self._lr_var,
            },
            {
                "ParamOut": p,
                "SquaredAccumOut": self._get_accumulator("squared", p),
                "LinearAccumOut": self._get_accumulator("linear", p),
            },
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


# reference spelling aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
Ftrl = FtrlOptimizer


def _make_persistent(block, startup, name, shape, value, init_from=None):
    """Persistable var in the main block + startup init (constant or
    copy-from another var).  Single definition for every accumulator
    these wrapper optimizers create."""
    v = block.create_var(name=name, shape=list(shape), dtype="float32",
                         persistable=True, stop_gradient=True)
    sv = startup.global_block.create_var(
        name=name, shape=list(shape), dtype="float32", persistable=True)
    if init_from is None:
        ConstantInitializer(value)(sv, startup.global_block)
    else:
        startup.global_block.append_op(
            "assign", {"X": [init_from]}, {"Out": [name]}, {})
    return v


class _ScopeSwap:
    """Shared apply()/restore() machinery for EMA / ModelAverage: swap
    computed values into the parameters, with backups held ON the
    instance so apply(need_restore=False) followed by a later
    restore() works (the reference pattern)."""

    def _swap_in(self, sc, values):
        self._backups = {}
        for pname, arr in values.items():
            import numpy as np

            self._backups[pname] = np.asarray(sc.get_var(pname)).copy()
            sc.set_var(pname, arr)
        self._backup_scope = sc

    def restore(self, executor=None, scope=None):
        from ..framework.scope import global_scope

        sc = scope or getattr(self, "_backup_scope", None) or global_scope()
        for pname, arr in (getattr(self, "_backups", None) or {}).items():
            sc.set_var(pname, arr)
        self._backups = {}

    def _guard(self, sc, values, need_restore):
        import contextlib

        @contextlib.contextmanager
        def guard():
            self._swap_in(sc, values)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(scope=sc)

        return guard()


class DpsgdOptimizer(Optimizer):
    """Differentially-private SGD (reference optimizer.py Dpsgd +
    operators/optimizers/dpsgd_op.cc): clip + Gaussian noise on the
    batch gradient."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kw):
        super().__init__(learning_rate, **kw)
        self._clip = float(clip)
        self._batch_size = float(batch_size)
        self._sigma = float(sigma)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "dpsgd",
            {"Param": p, "Grad": g, "LearningRate": self._lr_var},
            {"ParamOut": p},
            {"clip": self._clip, "batch_size": self._batch_size,
             "sigma": self._sigma},
        )


class ExponentialMovingAverage(_ScopeSwap):
    """EMA of parameters (reference fluid.optimizer.
    ExponentialMovingAverage, optimizer.py:3443): ``update()`` appends
    shadow-accumulator ops to the current main program (run them every
    train step); ``apply(exe)`` swaps the bias-corrected shadow values
    into the parameters for evaluation (context manager, or
    need_restore=False + a later ``restore()``).  ``thres_steps`` turns
    on the reference's decay ramp min(decay, (1+t)/(10+t))."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._name = name or "ema"
        self._shadows = {}  # param name -> shadow var name
        self._step_name = None
        self._decay_hist = None  # prod of (per-step decay) for bias corr

    def update(self):
        from ..framework import unique_name
        from ..framework.program import (default_main_program,
                                         default_startup_program)

        main = default_main_program()
        startup = default_startup_program()
        block = main.global_block

        step = unique_name.generate(f"{self._name}_step")
        _make_persistent(block, startup, step, [1], 0.0)
        self._step_name = step
        block.append_op("increment", {"X": [step]}, {"Out": [step]},
                        {"step": 1.0})
        decay_inputs = {}
        if self._thres_steps is not None:
            # ramped decay: min(decay, (1+t)/(10+t)) — early steps lean
            # on recent weights instead of the near-zero shadow
            num = unique_name.generate(f"{self._name}_dnum")
            den = unique_name.generate(f"{self._name}_dden")
            ramp = unique_name.generate(f"{self._name}_ramp")
            for nm in (num, den, ramp):
                block.create_var(name=nm, shape=[1], dtype="float32",
                                 stop_gradient=True)
            block.append_op("scale", {"X": [step]}, {"Out": [num]},
                            {"scale": 1.0, "bias": 1.0,
                             "bias_after_scale": True})
            block.append_op("scale", {"X": [step]}, {"Out": [den]},
                            {"scale": 1.0, "bias": 10.0,
                             "bias_after_scale": True})
            block.append_op("elementwise_div",
                            {"X": [num], "Y": [den]}, {"Out": [ramp]},
                            {"axis": -1})
            block.append_op("clip", {"X": [ramp]}, {"Out": [ramp]},
                            {"min": 0.0, "max": self._decay})
            decay_inputs = {"Decay": [ramp]}
            # bias correction needs prod(decay_t): carry it as state
            hist = unique_name.generate(f"{self._name}_dhist")
            _make_persistent(block, startup, hist, [1], 1.0)
            block.append_op("elementwise_mul",
                            {"X": [hist], "Y": [ramp]}, {"Out": [hist]},
                            {"axis": -1})
            self._decay_hist = hist
        for p in main.all_parameters():
            shadow = unique_name.generate(f"{p.name}_{self._name}")
            _make_persistent(block, startup, shadow, p.shape, 0.0)
            block.append_op(
                "ema_update",
                {"Param": [p.name], "Shadow": [shadow], **decay_inputs},
                {"ShadowOut": [shadow]}, {"decay": self._decay})
            self._shadows[p.name] = shadow

    def apply(self, executor=None, need_restore=True, scope=None):
        """params <- shadow / (1 - prod(decay_t))  (bias corrected)."""
        import numpy as np

        from ..framework.scope import global_scope

        sc = scope or global_scope()
        if self._decay_hist is not None and sc.has_var(self._decay_hist):
            prod = float(np.asarray(sc.get_var(self._decay_hist))
                         .ravel()[0])
        else:
            t = float(np.asarray(sc.get_var(self._step_name)).ravel()[0]) \
                if self._step_name and sc.has_var(self._step_name) else 0.0
            prod = self._decay ** t if t > 0 else 0.0
        corr = max(1.0 - prod, 1e-12)
        values = {p: np.asarray(sc.get_var(s)) / corr
                  for p, s in self._shadows.items()}
        return self._guard(sc, values, need_restore)


class ModelAverage(_ScopeSwap):
    """Windowed average of parameters (reference fluid.optimizer.
    ModelAverage, optimizer.py:3134).  The reference bounds the window
    with a sum_1/sum_2/sum_3 rotation; here a TWO-buffer masked
    rotation keeps the averaging window within
    [max_average_window, 2*max_average_window] with one fewer buffer
    (no control flow — the rotation is a masked select, XLA-friendly):
    when the current buffer's count hits the window, it rolls into the
    old buffer and restarts."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, name=None):
        self._name = name or "model_avg"
        self._window = max(1, int(max_average_window))
        self._sums = {}       # param -> (sum_cur, sum_old)
        self._cnt_cur = None
        self._cnt_old = None
        self.update()

    def update(self):
        from ..framework import unique_name
        from ..framework.program import (default_main_program,
                                         default_startup_program)

        main = default_main_program()
        startup = default_startup_program()
        block = main.global_block

        def temp(name, shape=(1,)):
            block.create_var(name=name, shape=list(shape),
                             dtype="float32", stop_gradient=True)
            return name

        cnt = unique_name.generate(f"{self._name}_cnt")
        cnt_old = unique_name.generate(f"{self._name}_cnt_old")
        _make_persistent(block, startup, cnt, [1], 0.0)
        _make_persistent(block, startup, cnt_old, [1], 0.0)
        self._cnt_cur, self._cnt_old = cnt, cnt_old
        block.append_op("increment", {"X": [cnt]}, {"Out": [cnt]},
                        {"step": 1.0})
        # rotation mask: cnt == window
        w = temp(unique_name.generate(f"{self._name}_w"))
        block.append_op("fill_constant", {}, {"Out": [w]},
                        {"shape": [1], "dtype": "float32",
                         "value": float(self._window)})
        cond = unique_name.generate(f"{self._name}_cond")
        block.create_var(name=cond, shape=[1], dtype="bool",
                         stop_gradient=True)
        block.append_op("equal", {"X": [cnt], "Y": [w]}, {"Out": [cond]})
        mask = temp(unique_name.generate(f"{self._name}_mask"))
        block.append_op("cast", {"X": [cond]}, {"Out": [mask]},
                        {"out_dtype": "float32"})
        inv = temp(unique_name.generate(f"{self._name}_inv"))
        block.append_op("scale", {"X": [mask]}, {"Out": [inv]},
                        {"scale": -1.0, "bias": 1.0,
                         "bias_after_scale": True})

        def rotate(cur, old, shape=(1,)):
            # old' = (1-mask)*old + mask*cur ; cur' = (1-mask)*cur
            keep = temp(unique_name.generate(f"{self._name}_keep"),
                        shape=shape)
            roll = temp(unique_name.generate(f"{self._name}_roll"),
                        shape=shape)
            block.append_op("elementwise_mul", {"X": [old], "Y": [inv]},
                            {"Out": [keep]}, {"axis": -1})
            block.append_op("elementwise_mul", {"X": [cur], "Y": [mask]},
                            {"Out": [roll]}, {"axis": -1})
            block.append_op("elementwise_add", {"X": [keep], "Y": [roll]},
                            {"Out": [old]}, {"axis": -1})
            block.append_op("elementwise_mul", {"X": [cur], "Y": [inv]},
                            {"Out": [cur]}, {"axis": -1})

        for p in main.all_parameters():
            s = unique_name.generate(f"{p.name}_{self._name}_sum")
            s_old = unique_name.generate(f"{p.name}_{self._name}_sum_old")
            _make_persistent(block, startup, s, p.shape, 0.0)
            _make_persistent(block, startup, s_old, p.shape, 0.0)
            block.append_op("elementwise_add",
                            {"X": [s], "Y": [p.name]}, {"Out": [s]},
                            {"axis": -1})
            rotate(s, s_old, shape=p.shape)
            self._sums[p.name] = (s, s_old)
        rotate(cnt, cnt_old)

    def apply(self, executor=None, need_restore=True, scope=None):
        import numpy as np

        from ..framework.scope import global_scope

        sc = scope or global_scope()
        n = (float(np.asarray(sc.get_var(self._cnt_cur)).ravel()[0])
             + float(np.asarray(sc.get_var(self._cnt_old)).ravel()[0]))
        values = {}
        if n > 0:
            for pname, (s, s_old) in self._sums.items():
                values[pname] = (np.asarray(sc.get_var(s))
                                 + np.asarray(sc.get_var(s_old))) / n
        return self._guard(sc, values, need_restore)


class LookaheadOptimizer:
    """Lookahead wrapper (reference optimizer.py:4853): the inner
    optimizer updates the fast weights every step; every k steps the
    slow weights move toward the fast ones (slow += alpha*(fast-slow))
    and the fast weights reset to them.  Masked-update form (no
    control flow), like GradientMergeOptimizer."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        self.inner = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..framework import unique_name
        from ..framework.program import default_startup_program

        ops, pgs = self.inner.minimize(loss, startup_program,
                                       parameter_list, no_grad_set)
        main = loss.block.program
        startup = startup_program or default_startup_program()
        block = main.global_block

        def persistent(name, shape, value, init_from=None):
            return _make_persistent(block, startup, name, shape, value,
                                    init_from=init_from)

        step = unique_name.generate("la_step")
        persistent(step, [1], 0.0)
        block.append_op("increment", {"X": [step]}, {"Out": [step]},
                        {"step": 1.0})
        k_const = unique_name.generate("la_k")
        block.append_op("fill_constant", {}, {"Out": [k_const]},
                        {"shape": [1], "dtype": "float32",
                         "value": float(self.k)})
        cond = unique_name.generate("la_cond")
        block.create_var(name=cond, shape=[1], dtype="bool",
                         stop_gradient=True)
        block.append_op("equal", {"X": [step], "Y": [k_const]},
                        {"Out": [cond]})
        mask = unique_name.generate("la_mask")
        block.create_var(name=mask, shape=[1], dtype="float32",
                         stop_gradient=True)
        block.append_op("cast", {"X": [cond]}, {"Out": [mask]},
                        {"out_dtype": "float32"})
        inv = unique_name.generate("la_inv")
        block.create_var(name=inv, shape=[1], dtype="float32",
                         stop_gradient=True)
        block.append_op("scale", {"X": [mask]}, {"Out": [inv]},
                        {"scale": -1.0, "bias": 1.0,
                         "bias_after_scale": True})
        block.append_op("elementwise_mul", {"X": [step], "Y": [inv]},
                        {"Out": [step]}, {"axis": -1})

        for p, _ in pgs:
            slow = unique_name.generate(p.name + "_la_slow")
            persistent(slow, p.shape, 0.0, init_from=p.name)
            # slow' = slow + mask*alpha*(fast - slow)
            diff = unique_name.generate(p.name + "_la_diff")
            block.create_var(name=diff, shape=list(p.shape),
                             dtype="float32", stop_gradient=True)
            block.append_op("elementwise_sub",
                            {"X": [p.name], "Y": [slow]}, {"Out": [diff]},
                            {"axis": -1})
            block.append_op("scale", {"X": [diff]}, {"Out": [diff]},
                            {"scale": self.alpha, "bias": 0.0,
                             "bias_after_scale": True})
            block.append_op("elementwise_mul",
                            {"X": [diff], "Y": [mask]}, {"Out": [diff]},
                            {"axis": -1})
            block.append_op("elementwise_add",
                            {"X": [slow], "Y": [diff]}, {"Out": [slow]},
                            {"axis": -1})
            # fast' = (1-mask)*fast + mask*slow'
            keep = unique_name.generate(p.name + "_la_keep")
            block.create_var(name=keep, shape=list(p.shape),
                             dtype="float32", stop_gradient=True)
            block.append_op("elementwise_mul",
                            {"X": [p.name], "Y": [inv]}, {"Out": [keep]},
                            {"axis": -1})
            upd = unique_name.generate(p.name + "_la_upd")
            block.create_var(name=upd, shape=list(p.shape),
                             dtype="float32", stop_gradient=True)
            block.append_op("elementwise_mul",
                            {"X": [slow], "Y": [mask]}, {"Out": [upd]},
                            {"axis": -1})
            block.append_op("elementwise_add",
                            {"X": [keep], "Y": [upd]}, {"Out": [p.name]},
                            {"axis": -1})
        main._bump()
        return ops, pgs


Dpsgd = DpsgdOptimizer
