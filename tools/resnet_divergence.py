#!/usr/bin/env python3
"""Where two float32 runs of one ResNet-50 training step part.

One startup (float32, ``chip_smoke.build_resnet``, lr 1e-3) on the card is
copied to the CPU.  Then one step of ``chip_smoke.resnet_feed(4, seed=1)``
runs as two chains op by op, each from its own state, and every floating
output of every op is compared between them (largest |a - b| over a's
largest magnitude, and the same in the Frobenius norm):

- ``card_cpu``: the card's chain against the CPU's (``CPUPlace``);
- ``cpu_ulp``: the CPU's chain against the CPU's on an image moved by one
  float32 ulp (``np.nextafter``), which no implementation can be held to.

Where the two modes show the same gaps, the card computes what the CPU
computes, and the gaps are the step's own sensitivity to float32
rounding.  For each ``relu`` the log counts the outputs whose sign
differs between the chains (``flips``) and the inputs within 1e-5 of the
largest (``near0``).  Run from the repository root on a host with a card:

    python3 tools/resnet_divergence.py card_cpu
    python3 tools/resnet_divergence.py cpu_ulp

It prints the losses, every op from the last block's ``relu`` to the
backward through the last block (``--ops``), the eight parameter
gradients that part most, and the median gap of all parameter gradients.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.framework.executor import _feed_tensors  # noqa: E402
from paddle_tpu_torch.framework.lowering import (  # noqa: E402
    PSEUDO_OPS, LoweringContext, get_lowering)


def chain(exe, main, scope, feed):
    """The step's environment and lowering context on ``exe``'s device."""
    block = main.global_block
    state_in, _ = exe._analysis(main, set(feed), scope)
    env = {n: scope.get_var(n) for n in state_in}
    env.update(_feed_tensors(block, feed, exe.device))
    return env, LoweringContext(block, env, exe.device,
                                exe._generator(scope, main))


def gaps(a, b):
    a, b = a.cpu().double(), b.double()
    d = a - b
    return (float(d.abs().max() / a.abs().max().clamp_min(1e-30)),
            float(d.norm() / a.norm().clamp_min(1e-30)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("card_cpu", "cpu_ulp"))
    ap.add_argument("--ops", default="170:197",
                    help="op index range to print, first:last+1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("resnet_divergence: no CUDA device", file=sys.stderr)
        return 1
    main_p, startup, loss = cs.build_resnet(amp=False, lr=1e-3)
    card_exe, cpu_exe = pt.Executor(), pt.Executor(pt.CPUPlace())
    card = pt.framework.Scope()
    card_exe.run(startup, scope=card)
    host, host2 = cs.host_copy(card), cs.host_copy(card)
    feed = cs.resnet_feed(4, seed=1)
    if args.mode == "cpu_ulp":
        feed_b = dict(feed, image=np.nextafter(feed["image"],
                                               np.float32(np.inf)))
        (ea, ca), (eb, cb) = (chain(cpu_exe, main_p, host, feed),
                              chain(cpu_exe, main_p, host2, feed_b))
    else:
        (ea, ca), (eb, cb) = (chain(card_exe, main_p, card, feed),
                              chain(cpu_exe, main_p, host, feed))
    rows = []
    with torch.no_grad():
        for i, op in enumerate(main_p.global_block.ops):
            if op.type in PSEUDO_OPS:
                continue
            get_lowering(op.type)(ca, op)
            get_lowering(op.type)(cb, op)
            for n in dict.fromkeys(op.output_arg_names()):
                a, b = ea[n], eb[n]
                if not a.is_floating_point():
                    continue
                extra = {}
                if op.type == "relu":
                    ad, bd = a.cpu().double(), b.double()
                    x = ea[op.inputs["X"][0]].cpu().double()
                    extra = {"flips": int(((ad > 0) != (bd > 0)).sum()),
                             "near0": int((x.abs() < 1e-5 * x.abs().max())
                                          .sum()),
                             "of": x.numel()}
                rows.append([i, op.type, n, *gaps(a, b), extra])
    print(json.dumps({"mode": args.mode, "loss": [
        float(ea[loss.name].ravel()[0]), float(eb[loss.name].ravel()[0])]}))
    lo, hi = (int(v) for v in args.ops.split(":"))
    for r in rows:
        if lo <= r[0] < hi:
            print(json.dumps(r))
    grads = sorted((r for r in rows if r[2].endswith((".w_0@GRAD",
                                                      ".b_0@GRAD"))),
                   key=lambda r: -r[4])
    print(json.dumps({"worst_param_grads_by_norm": grads[:8]}))
    print(json.dumps({"median_param_grad_norm_gap": float(
        np.median([r[4] for r in grads])), "param_grads": len(grads)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
