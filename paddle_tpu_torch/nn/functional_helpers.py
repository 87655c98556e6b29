"""Small shared pieces for nn.functional (dual-mode safe); counterpart
of ``paddle_tpu/nn/functional_helpers.py``."""
from __future__ import annotations

from ..tensor.manipulation import take_along_axis, unsqueeze, squeeze


def gather_label_scores(scores, label):
    """Pick scores[i, label[i]] for each row; label is [N] or [N, 1]."""
    lbl = label
    if len(lbl.shape) == len(scores.shape) - 1:
        lbl = unsqueeze(lbl, -1)
    picked = take_along_axis(scores, lbl, axis=-1)
    return squeeze(picked, -1)
