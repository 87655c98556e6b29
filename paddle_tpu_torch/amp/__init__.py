"""`paddle.amp` equivalent: ``auto_cast`` + ``GradScaler`` + ``decorate``.

Counterpart of ``paddle_tpu/amp/__init__.py`` (reference
python/paddle/amp/: auto_cast.py:91 `amp_guard`, grad_scaler.py, and
imperative/amp_auto_cast.{h,cc}).  ``auto_cast`` arms the white / black
/ gray-follow casts that dygraph's ``run_op`` applies to each eager op's
inputs (``dygraph/eager.py``); the static program rewrite is
``static_amp.decorate``.

``decorate`` serves both modes: given a static-graph optimizer (the
builders of ``optimizer/static_opt.py``) it is ``static_amp.decorate``
(``decorate(opt, use_bf16=True).minimize(loss)``), otherwise the
dygraph ``decorate(models, optimizers, level, dtype)`` of the JAX
package (O1: nothing to do; O2: the parameters cast to ``dtype``).

``GradScaler.unscale_`` checks every gradient for inf / NaN on the
device and reads the verdict with ONE host sync for all of them (the JAX
package syncs once per parameter).
"""
from __future__ import annotations

import contextlib
from typing import Optional  # noqa: F401  (API.spec names it)

import torch

from .lists import AutoMixedPrecisionLists  # noqa: F401
from .static_amp import decorate as static_decorate  # noqa: F401


class _AmpState:
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.lists = AutoMixedPrecisionLists()

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Dygraph autocast guard (reference amp_guard): eager ops on the white
    list run in `dtype`; black-list ops in fp32; gray ops follow inputs.
    Implemented as an input-cast hook in the eager dispatcher."""
    prev = (_state.enabled, _state.dtype, _state.level, _state.lists)
    _state.enabled = bool(enable)
    _state.dtype = {"float16": "float16", "bfloat16": "bfloat16"}[dtype]
    _state.level = level
    _state.lists = AutoMixedPrecisionLists(custom_white_list, custom_black_list)
    try:
        yield
    finally:
        _state.enabled, _state.dtype, _state.level, _state.lists = prev


amp_guard = auto_cast


class GradScaler:
    """Dynamic loss scaling (reference paddle/amp/grad_scaler.py)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        from ..tensor.math import scale as _scale

        return _scale(loss, self._scale)

    def unscale_(self, optimizer):
        """Divide every gradient by the scale, in place, and note whether
        any holds an inf or a NaN: one host sync for all of them."""
        if not self._enable:
            return
        grads = [p._value.grad for p in
                 getattr(optimizer, "_parameter_list", None) or []
                 if p._value.grad is not None]
        if not grads:
            self._found_inf = False
            return
        inv = 1.0 / self._scale
        with torch.no_grad():
            finite = []
            for g in grads:
                g.mul_(inv)
                finite.append(torch.isfinite(g).all())
            self._found_inf = not bool(torch.stack(finite).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good,
                "bad_steps": self._bad}

    def set_state_dict(self, state):
        self._scale = float(state.get("scale", self._scale))
        self._good = int(state.get("good_steps", 0))
        self._bad = int(state.get("bad_steps", 0))


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, **kwargs):
    """Dygraph decorate (reference paddle.amp.decorate): O1 needs no model
    surgery (autocast handles it); O2 casts parameters to `dtype`.  Given
    a static-graph optimizer first, it is ``static_amp.decorate``."""
    from ..optimizer.static_opt import Optimizer as StaticOptimizer

    if isinstance(models, StaticOptimizer):
        return static_decorate(models, *([optimizers] if optimizers
                                         is not None else []), **kwargs)
    if level == "O2" and models is not None:
        td = getattr(torch, dtype)
        model_list = models if isinstance(models, (list, tuple)) else [models]
        for m in model_list:
            for p in m.parameters():
                p._set_raw(p._value.to(td))
    if optimizers is None:
        return models
    return models, optimizers
