"""`paddle.metric` equivalent (reference python/paddle/metric/metrics.py).

Counterpart of ``paddle_tpu/metric/__init__.py``.  The metrics' state
and arithmetic are numpy on the host, as there: ``Accuracy.compute``
copies the predictions to the host and ranks them with ``argsort`` (the
reference's own per-batch sync).  The functional ``accuracy`` runs the
``accuracy`` op (``ops/misc.py``) on the inputs' device, eagerly or in a
static program.
"""
from __future__ import annotations

import numpy as np


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing of (pred, label); default
        passthrough."""
        return args


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        maxk = max(self.topk)
        order = np.argsort(-pred_np, axis=-1)[..., :maxk]
        correct = (order == label_np[..., None]).astype("f4")
        return correct

    def update(self, correct):
        correct = _np(correct)
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].sum()
            self.count[i] += correct.shape[0]
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = (self.total / np.maximum(self.count, 1)).tolist()
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype("i4").ravel()
        labels = _np(labels).astype("i4").ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype("i4").ravel()
        labels = _np(labels).astype("i4").ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Streaming ROC-AUC via histogram buckets (reference metrics.py Auc /
    operators/metrics/auc_op)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name or "auc"
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.ravel()
        labels = _np(labels).ravel()
        buckets = np.minimum((preds * self.num_thresholds).astype("i8"),
                             self.num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = tot_neg = auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            pos, neg = self._stat_pos[i], self._stat_neg[i]
            auc += neg * (tot_pos + pos + tot_pos) / 2.0  # trapezoid
            tot_pos += pos
            tot_neg += neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Functional accuracy (reference paddle.metric.accuracy)."""
    from ..dispatch import op_call
    from ..tensor.search import topk as _topk

    values, indices = _topk(input, k)
    res = op_call("accuracy", {"Out": values, "Indices": indices,
                               "Label": label}, {},
                  outs=("Accuracy",))
    return res
