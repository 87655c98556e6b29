#!/usr/bin/env python3
"""Read ``chip_smoke``'s ``hapi_oracle`` with faults planted on the card,
to show what its bounds can see.  Each fault applies to CUDA tensors
only, so the CPU reference stays right:

- ``bn_dropped_term``: batch norm's backward loses dX's ``x_hat * dScale
  / N`` term (``tools/dygraph_oracle_faults.py``'s fault, in the 52 batch
  norms of MobileNetV2);
- ``no_weight_decay``: the dygraph ``Momentum`` step drops its L2 weight
  decay (4e-5 * w added to each gradient).

Prints, per fault, the phase's log line (the update's gap beside its
bound) and whether the phase failed.  Needs one CUDA card; exits 1 if the
batch-norm fault passed (the weight-decay fault is expected to stay
under the bound: its share of the update is about 1e-3).

    python3 tools/hapi_oracle_faults.py
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from paddle_tpu_torch import optimizer  # noqa: E402
from paddle_tpu_torch.ops import nn_ops  # noqa: E402
from tools.dygraph_oracle_faults import planted  # noqa: E402


def no_decay(right):
    def decayed(self, p, g):
        return g if g.is_cuda else right(self, p, g)
    return decayed


FAULTS = {
    "bn_dropped_term": (nn_ops, "_bn_train_grads",
                        lambda right: planted("dropped_term", right)),
    "no_weight_decay": (optimizer.Optimizer, "_decayed_grad", no_decay),
}


def main():
    if not torch.cuda.is_available():
        print("hapi_oracle_faults: no CUDA device", file=sys.stderr)
        return 1
    failed = {}
    for name, (owner, attr, make) in FAULTS.items():
        right = getattr(owner, attr)
        setattr(owner, attr, make(right))
        reason = None
        try:
            chip_smoke.phase_hapi_oracle()
        except RuntimeError as e:
            reason = str(e)
        finally:
            setattr(owner, attr, right)
        failed[name] = reason is not None
        chip_smoke.log("hapi_oracle_fault", fault=name,
                       phase_failed=failed[name], reason=reason)
        chip_smoke.release("hapi_oracle_fault")
    return 0 if failed["bn_dropped_term"] else 1


if __name__ == "__main__":
    sys.exit(main())
