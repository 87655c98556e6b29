#!/usr/bin/env python3
"""Dygraph ResNet-50 training steps with batch norm's backward two ways,
on one CUDA card, in one process.

``closed_form`` is the port's eager rule (``ops/nn_ops.py``
``batch_norm_eager``: batch statistics through ``_BatchNormTrain``, whose
backward is the closed form of the static ``batch_norm_grad``);
``autograd`` runs the registered lowering instead, so autograd
differentiates its one-pass moments.  Each run is ``chip_smoke``'s
``dygraph_resnet`` training (bf16 ``auto_cast``, ``Momentum(0.1, 0.9)``,
224x224, warm-up steps, then synced timed steps) at ``--batch``, in the
order A B B A.  Prints one JSON line per run: step p50 and every step's
ms, peak device memory, the first losses.

    python3 tools/dygraph_bn_ab.py --batch 128
"""
import argparse
import gc
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from paddle_tpu_torch.dygraph import eager  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dygraph_bn_ab: no CUDA device", file=sys.stderr)
        return 1
    rules = eager._EAGER_RULES
    print(json.dumps({"card": chip_smoke.nvidia_smi("name,power.limit")}),
          flush=True)
    for variant in ("autograd", "closed_form", "closed_form", "autograd"):
        eager._EAGER_RULES = {} if variant == "autograd" else rules
        try:
            report, state = chip_smoke.dygraph_train(args.batch)
        finally:
            eager._EAGER_RULES = rules
        print(json.dumps(dict(
            variant=variant, batch=args.batch,
            step_ms_p50=float(np.median(report["step_ms"])),
            step_ms=report["step_ms"], peak_gb=report["peak_last_gb"],
            losses=report["losses"][:4])), flush=True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
