#!/usr/bin/env python3
"""Run ``chip_smoke``'s ``capture_concurrency`` phase with the profiler
closed right after the card went idle, and kept open
``chip_smoke.PROFILER_TAIL_S`` longer, alternately, on one CUDA card.

Per window prints one JSON line: the tail, whether the phase passed (its
B5 / B6 wrapper counts against the engines' steps and against the
profiler's kernel records), the profiler's B5 records, and how far the
card's last record ends after the host's last synchronize call returned,
both on the profiler's clock (positive: the card's converted timestamps
run ahead of the host's).

    python3 tools/profiler_tail.py --windows 10
"""
import argparse
import json
import os
import sys

import torch
import torch.profiler

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_tail: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType

    print(json.dumps({"card": chip_smoke.nvidia_smi("name,power.limit")}),
          flush=True)
    real, tail, made = torch.profiler.profile, chip_smoke.PROFILER_TAIL_S, []

    def profile(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    for i in range(args.windows):
        chip_smoke.PROFILER_TAIL_S = 0.0 if i % 2 == 0 else tail
        torch.profiler.profile = profile
        try:
            chip_smoke.phase_capture_concurrency()
            failed = None
        except RuntimeError as e:
            failed = str(e)
        finally:
            torch.profiler.profile, chip_smoke.PROFILER_TAIL_S = real, tail
        events = made[-1].events()
        sync_end = max(e.time_range.end for e in events
                       if e.device_type == DeviceType.CPU
                       and "Synchronize" in e.name)
        card = [e for e in events if e.device_type == DeviceType.CUDA]
        print(json.dumps(dict(
            window=i, tail_s=0.0 if i % 2 == 0 else tail,
            passed=failed is None, failure=failed,
            profiler_b5=sum("paged_decode_kernel" in e.name for e in card),
            card_last_end_after_host_sync_us=max(
                e.time_range.end for e in card) - sync_end)), flush=True)
        chip_smoke.release("capture_concurrency")
    return 0


if __name__ == "__main__":
    sys.exit(main())
