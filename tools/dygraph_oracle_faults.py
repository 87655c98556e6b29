#!/usr/bin/env python3
"""Read ``chip_smoke``'s ``dygraph_resnet_oracle`` with faults planted in
batch norm's backward on the card, to show what its bounds can see.

Each fault replaces ``ops/nn_ops.py``'s ``_bn_train_grads`` (the closed
form behind ``_BatchNormTrain``'s backward) by a wrong one for CUDA
tensors only, so the CPU reference stays right, then runs the phase:

- ``dropped_term``: dX loses its ``x_hat * dScale / N`` term;
- ``n_minus_1``: dX divides its two mean terms by ``N - 1``, not ``N``.

Prints, per fault, the phase's log line (the card's gradient errors
beside the bounds) and whether the phase failed, as it should.  Needs one
CUDA card; exits 1 if a fault passed.

    python3 tools/dygraph_oracle_faults.py
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops import nn_ops  # noqa: E402


def planted(name, right):
    def grads(x, scale, dy, m, inv, red, bshape):
        if not x.is_cuda:
            return right(x, scale, dy, m, inv, red, bshape)
        acc = nn_ops._bn_acc(x)
        dyf = dy.to(acc)
        m_, inv_ = m.to(acc).reshape(bshape), inv.to(acc).reshape(bshape)
        x_hat = (x.to(acc) - m_) * inv_
        d_bias = dyf.sum(dim=red)
        d_scale = (dyf * x_hat).sum(dim=red)
        n = x.numel() // d_bias.numel()
        k = scale.to(acc).reshape(bshape) * inv_
        if name == "dropped_term":
            dx = k * (dyf - d_bias.reshape(bshape) / n)
        else:
            dx = k * (dyf - (d_bias.reshape(bshape)
                             + x_hat * d_scale.reshape(bshape)) / (n - 1))
        return dx.to(x.dtype), d_scale, d_bias
    return grads


def main():
    if not torch.cuda.is_available():
        print("dygraph_oracle_faults: no CUDA device", file=sys.stderr)
        return 1
    right, missed = nn_ops._bn_train_grads, []
    for name in ("dropped_term", "n_minus_1"):
        nn_ops._bn_train_grads = planted(name, right)
        try:
            chip_smoke.phase_dygraph_resnet_oracle()
            failed = False
        except RuntimeError as e:
            failed, reason = True, str(e)
        finally:
            nn_ops._bn_train_grads = right
        chip_smoke.log("oracle_fault", fault=name, phase_failed=failed,
                       reason=reason if failed else None)
        if not failed:
            missed.append(name)
        chip_smoke.release("oracle_fault")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
