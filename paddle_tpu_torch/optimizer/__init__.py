"""`paddle.optimizer` equivalent (reference python/paddle/optimizer/).

Counterpart of ``paddle_tpu/optimizer/__init__.py``.  2.0 optimizers
work in BOTH modes: in dygraph `step()` runs the SAME optimizer-op
lowering rules eagerly over (param, param.grad), under ``no_grad``, and
writes each new value into its parameter in place (the leaf keeps its
identity and its address); in static graph `minimize()` delegates to the
fluid-style program builders in static_opt.py.  One numerical
implementation per optimizer either way: ``SGD``, ``Momentum``, ``Adam``,
``AdamW``, ``Lamb``, ``Adagrad``, ``Adamax`` and ``RMSProp`` all have
their update's lowering (``ops/optimizer_ops.py``).  The pipeline
optimizer comes with the distributed slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import optimizer_lr as lr  # noqa: F401  (paddle.optimizer.lr.*)
from ..optimizer_lr import LRScheduler
from .static_opt import (  # noqa: F401  (fluid-compat re-exports)
    AdadeltaOptimizer,
    AdagradOptimizer,
    AdamaxOptimizer,
    AdamOptimizer,
    AdamWOptimizer,
    DpsgdOptimizer,
    ExponentialMovingAverage,
    FtrlOptimizer,
    LambOptimizer,
    LarsMomentumOptimizer,
    LookaheadOptimizer,
    ModelAverage,
    MomentumOptimizer,
    Optimizer as _FluidOptimizer,
    RMSPropOptimizer,
    SGDOptimizer,
)


class Optimizer:
    """2.0 optimizer base (reference python/paddle/optimizer/optimizer.py)."""

    _op_type: str = ""
    _fluid_cls = None

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **hyper):
        self._learning_rate = learning_rate
        self._parameter_list = list(parameters) if parameters is not None else None
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._name = name
        self._hyper = hyper
        self._accum: Dict[int, Dict[str, object]] = {}
        self._fluid_opt = None

    # -- learning rate ----------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)
        if self._fluid_opt is not None:
            self._fluid_opt.set_lr(value)

    # -- eager step -------------------------------------------------------
    def _accum_spec(self, p) -> Dict[str, tuple]:
        """name -> (shape_or_None_for_param_shape, fill_value)"""
        return {}

    def _io(self, p, g, lr_arr, acc):
        """Returns (inputs, attrs, out_slots, out_state_keys). Subclasses
        override; out_state_keys maps out slot -> accumulator name (or
        'param')."""
        raise NotImplementedError

    def _decayed_grad(self, p, g):
        wd = self._weight_decay
        if wd is None or isinstance(self, AdamW):
            return g
        coeff = getattr(wd, "_regularization_coeff", wd)
        try:
            coeff = float(coeff)
        except (TypeError, ValueError):
            return g
        if coeff == 0.0:
            return g
        return g + coeff * p._value

    def step(self):
        from ..dygraph.eager import run_op

        params = self._parameter_list or []
        params_grads = [(p, p.grad._value) for p in params
                        if p.grad is not None and p.trainable]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(
                [(p, g) for p, g in params_grads])
        lrs = {}
        with torch.no_grad():
            for p, g in params_grads:
                if g is None:
                    continue
                dev = p._value.device
                if dev not in lrs:
                    lrs[dev] = torch.full((1,), self.get_lr(),
                                          dtype=torch.float32, device=dev)
                g = self._decayed_grad(p, g)
                acc = self._accum.setdefault(id(p), self._init_accum(p))
                inputs, attrs, out_slots, out_keys = self._io(
                    p, g, lrs[dev], acc)
                res = run_op(self._op_type,
                             {k: v for k, v in inputs.items()
                              if v is not None},
                             attrs, out_slots=out_slots)
                for slot, key in out_keys.items():
                    t = res.get(slot)
                    if t is None:
                        continue
                    if key == "param":
                        p._set_raw(t._value.to(p._value.dtype))
                    else:
                        acc[key] = t._value

    def _init_accum(self, p):
        out = {}
        for name, (shape, fill) in self._accum_spec(p).items():
            shp = tuple(p.shape) if shape is None else tuple(shape)
            out[name] = torch.full(shp, fill, dtype=torch.float32,
                                   device=p._value.device)
        return out

    def clear_grad(self):
        for p in self._parameter_list or []:
            p.clear_grad()

    clear_gradients = clear_grad

    # -- static-mode delegation ------------------------------------------
    def _make_fluid(self):
        if self._fluid_opt is None:
            reg = None
            if self._weight_decay is not None and not isinstance(self, AdamW):
                from ..regularizer import L2Decay

                wd = self._weight_decay
                reg = wd if hasattr(wd, "__call__") or hasattr(
                    wd, "_regularization_coeff") else L2Decay(float(wd))
            self._fluid_opt = self._fluid_cls(
                learning_rate=self._learning_rate,
                regularization=reg, grad_clip=None,
                **self._fluid_kwargs())
        return self._fluid_opt

    def _fluid_kwargs(self):
        return dict(self._hyper)

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        from ..framework.program import Variable

        if isinstance(loss, Variable):
            return self._make_fluid().minimize(loss, startup_program,
                                               parameters, no_grad_set)
        loss.backward()
        self.step()
        return None, None

    # -- state ------------------------------------------------------------
    def state_dict(self):
        sd = {"LR_Scheduler": (self._learning_rate.state_dict()
                               if isinstance(self._learning_rate, LRScheduler) else {})}
        for p in self._parameter_list or []:
            acc = self._accum.get(id(p))
            if acc:
                for name, v in acc.items():
                    sd[f"{p.name}_{name}"] = v
        return sd

    def set_state_dict(self, state):
        import numpy as np

        if isinstance(self._learning_rate, LRScheduler) and state.get("LR_Scheduler"):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for p in self._parameter_list or []:
            acc = self._accum.setdefault(id(p), self._init_accum(p))
            for name in list(acc.keys()):
                key = f"{p.name}_{name}"
                if key in state:
                    v = state[key]
                    acc[name] = (v if isinstance(v, torch.Tensor)
                                 else torch.as_tensor(np.asarray(v))).to(
                                     acc[name].device, torch.float32)

    set_dict = set_state_dict


class SGD(Optimizer):
    _op_type = "sgd"
    _fluid_cls = SGDOptimizer

    def _io(self, p, g, lr, acc):
        return ({"Param": p, "Grad": g, "LearningRate": lr}, {},
                ("ParamOut",), {"ParamOut": "param"})


class Momentum(Optimizer):
    _op_type = "momentum"
    _fluid_cls = MomentumOptimizer

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         momentum=momentum, use_nesterov=use_nesterov)
        self._momentum, self._use_nesterov = momentum, use_nesterov

    def _accum_spec(self, p):
        return {"velocity": (None, 0.0)}

    def _io(self, p, g, lr, acc):
        return ({"Param": p, "Grad": g, "Velocity": acc["velocity"],
                 "LearningRate": lr},
                {"mu": self._momentum, "use_nesterov": self._use_nesterov},
                ("ParamOut", "VelocityOut"),
                {"ParamOut": "param", "VelocityOut": "velocity"})


class Adam(Optimizer):
    _op_type = "adam"
    _fluid_cls = AdamOptimizer

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         beta1=beta1, beta2=beta2, epsilon=epsilon)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _accum_spec(self, p):
        return {"moment1": (None, 0.0), "moment2": (None, 0.0),
                "beta1_pow": ([1], self._beta1), "beta2_pow": ([1], self._beta2)}

    def _attrs(self, p):
        return {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon}

    def _io(self, p, g, lr, acc):
        return ({"Param": p, "Grad": g, "Moment1": acc["moment1"],
                 "Moment2": acc["moment2"], "Beta1Pow": acc["beta1_pow"],
                 "Beta2Pow": acc["beta2_pow"], "LearningRate": lr},
                self._attrs(p),
                ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"),
                {"ParamOut": "param", "Moment1Out": "moment1",
                 "Moment2Out": "moment2", "Beta1PowOut": "beta1_pow",
                 "Beta2PowOut": "beta2_pow"})


class AdamW(Adam):
    _op_type = "adamw"
    _fluid_cls = AdamWOptimizer

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, grad_clip=None,
                 apply_decay_param_fun=None, lazy_mode=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, name)
        self._weight_decay = weight_decay if weight_decay is not None else 0.01
        self._apply_decay_param_fun = apply_decay_param_fun

    def _attrs(self, p):
        decay = float(self._weight_decay)
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(p.name)):
            decay = 0.0
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon, "coeff": decay,
                "with_decay": decay != 0.0}

    def _fluid_kwargs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon, "weight_decay": self._weight_decay,
                "apply_decay_param_fun": self._apply_decay_param_fun}


class Lamb(Adam):
    _op_type = "lamb"
    _fluid_cls = LambOptimizer

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, False, name)
        self._lamb_weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _attrs(self, p):
        wd = self._lamb_weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon, "weight_decay": float(wd)}

    def _fluid_kwargs(self):
        return {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon}


class Adagrad(Optimizer):
    _op_type = "adagrad"
    _fluid_cls = AdagradOptimizer

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, initial_accumulator_value=0.0,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         epsilon=epsilon)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _accum_spec(self, p):
        return {"moment": (None, self._init_val)}

    def _io(self, p, g, lr, acc):
        return ({"Param": p, "Grad": g, "Moment": acc["moment"], "LearningRate": lr},
                {"epsilon": self._epsilon},
                ("ParamOut", "MomentOut"),
                {"ParamOut": "param", "MomentOut": "moment"})


class Adamax(Optimizer):
    _op_type = "adamax"
    _fluid_cls = AdamaxOptimizer

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         beta1=beta1, beta2=beta2, epsilon=epsilon)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _accum_spec(self, p):
        return {"moment": (None, 0.0), "inf_norm": (None, 0.0),
                "beta1_pow": ([1], self._beta1)}

    def _io(self, p, g, lr, acc):
        return ({"Param": p, "Grad": g, "Moment": acc["moment"],
                 "InfNorm": acc["inf_norm"], "Beta1Pow": acc["beta1_pow"],
                 "LearningRate": lr},
                {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
                ("ParamOut", "MomentOut", "InfNormOut"),
                {"ParamOut": "param", "MomentOut": "moment",
                 "InfNormOut": "inf_norm"})

    def step(self):
        super().step()
        # beta1_pow advances outside the op (reference _finish_update)
        for p in self._parameter_list or []:
            acc = self._accum.get(id(p))
            if acc and "beta1_pow" in acc:
                acc["beta1_pow"] = acc["beta1_pow"] * self._beta1


class RMSProp(Optimizer):
    _op_type = "rmsprop"
    _fluid_cls = RMSPropOptimizer

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         rho=rho, epsilon=epsilon, momentum=momentum, centered=centered)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _accum_spec(self, p):
        return {"mean_square": (None, 0.0), "mean_grad": (None, 0.0),
                "momentum": (None, 0.0)}

    def _io(self, p, g, lr, acc):
        return ({"Param": p, "Grad": g, "MeanSquare": acc["mean_square"],
                 "MeanGrad": acc["mean_grad"], "Moment": acc["momentum"],
                 "LearningRate": lr},
                {"decay": self._rho, "epsilon": self._epsilon,
                 "momentum": self._momentum, "centered": self._centered},
                ("ParamOut", "MeanSquareOut", "MeanGradOut", "MomentOut"),
                {"ParamOut": "param", "MeanSquareOut": "mean_square",
                 "MeanGradOut": "mean_grad", "MomentOut": "momentum"})
