"""Gradient clipping (reference python/paddle/fluid/clip.py; 2.0 re-exports
as paddle.nn.ClipGradBy*).

Counterpart of ``paddle_tpu/nn/clip.py``, on torch tensors.  The 2.0
optimizers' ``step`` calls the clip object on ``[(parameter, gradient
tensor)]`` and updates with what it returns; every clip computes on the
gradients' device and never syncs with the host (the global norm's scale
stays a device tensor).
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def _dygraph_clip(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, None if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(g * g))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _dygraph_clip(self, params_grads):
        sq = [torch.sum(g * g) for _, g in params_grads if g is not None]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(torch.stack(sq).sum())
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(p, None if g is None else g * scale) for p, g in params_grads]


# fluid-compat aliases
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
