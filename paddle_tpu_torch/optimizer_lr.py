"""Learning-rate schedulers.

Copy of ``paddle_tpu/optimizer_lr.py`` (the JAX package's module imports no
JAX); the program it builds is the same, op for op.

Role parity: reference python/paddle/fluid/dygraph/learning_rate_scheduler.py
and paddle.optimizer.lr.  Host-side design: ``step()`` computes the new LR
and writes the scalar into the scope var the compiled train step reads —
a 4-byte H2D per step, no recompile (the reference instead builds LR
subgraphs with ops; the value-update contract is identical).
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self._optimizer = None
        self.step()

    def _bind(self, optimizer):
        self._optimizer = optimizer

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch=None):
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = self.get_lr()
        if self._optimizer is not None:
            self._optimizer.set_lr(self.last_lr)

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state.get("last_epoch", self.last_epoch)
        self.last_lr = state.get("last_lr", self.last_lr)


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, **kw):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (
            self.base_lr
            * self.d_model ** -0.5
            * min(step**-0.5, step * self.warmup_steps**-1.5)
        )


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, **kw):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], **kw)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * self.gamma**self.last_epoch


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, **kw):
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0, cycle=False, **kw):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle and step > 0:
            decay_steps = self.decay_steps * math.ceil(step / self.decay_steps)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        frac = (1 - step / max(decay_steps, 1)) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, **kw):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self.last_epoch / self.T_max))
            / 2
        )


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, **kw):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = end_lr if not isinstance(learning_rate, LRScheduler) else learning_rate.base_lr
        super().__init__(base, **kw)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * self.last_epoch / self.warmup_steps
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr_after.get_lr()
        return float(self.lr_after)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, **kw):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, **kw):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma**n


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, **kw):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class ReduceOnPlateau(LRScheduler):
    def __init__(
        self,
        learning_rate,
        mode="min",
        factor=0.1,
        patience=10,
        threshold=1e-4,
        cooldown=0,
        min_lr=0.0,
        **kw,
    ):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._lr = float(learning_rate)
        super().__init__(learning_rate, **kw)

    def get_lr(self):
        return self._lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        val = float(metrics)
        better = (
            self.best is None
            or (self.mode == "min" and val < self.best - self.threshold)
            or (self.mode == "max" and val > self.best + self.threshold)
        )
        if better:
            self.best = val
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        self.last_lr = self._lr
        if self._optimizer is not None:
            self._optimizer.set_lr(self._lr)
