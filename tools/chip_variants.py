#!/usr/bin/env python3
"""Time versions of B1, B3/B4 and B7 side by side on one CUDA card.

Each version is a kernel source (``flash_attention.cu`` for B1,
``flash_attention_bwd.cu`` for B3 and B4, ``dequant_matmul.cu`` for B7) in
a directory of its own, built with the port's flags
(``paddle_tpu_torch/native/build.py``) plus any ``-D`` flags given, into a
library of its own.  The wrappers in ``paddle_tpu_torch/ops`` are pointed
at each library in turn, and every bfloat16 case of
``chip_smoke.FLASH_CASES``, every case of ``chip_smoke.TRAIN_FLASH_CASES``
(B3 and B4, on the operands of the checkout's B2) and every case of
``chip_smoke.DEQUANT_CASES`` runs through each version on the same inputs:
checked against the plain version with ``chip_smoke``'s tolerances and
timed by ``chip_smoke.cuda_ms`` (L2 flushed, card time only) and by
``torch.profiler`` (kernel time, L2 warm), beside the library call.
Versions compared in one run share a card, a host and inputs.

    python3 tools/chip_variants.py \\
        --b1 '{"parent": {"dir": "_parent/csrc"}, "change": {}}' \\
        --bwd '{"parent": {"dir": "_parent/csrc"}, "change": {}}' \\
        --b7 '{"parent": {"dir": "_parent/csrc", "old_api": true},
               "change": {}}'

where ``_parent/csrc`` holds the earlier sources, e.g. from
``git archive HEAD~1 paddle_tpu_torch/csrc``.  ``{}`` is the checkout's
own source; ``"defs": ["-DNAME=1"]`` adds compiler flags; ``"old_api"``
calls B7's entry point as it was before it took a split-K workspace.
Prints one JSON line per case: ``[cuda_ms, profiler_us, share of the
tolerance]`` per version.
"""
import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.native import build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import flash_attention_bias as fab  # noqa: E402
from paddle_tpu_torch.ops import quant_ops as qo  # noqa: E402

OUT = os.path.join(build.OUT_DIR, "variants")
SOURCE = {"b1": "flash_attention.cu", "bwd": "flash_attention_bwd.cu",
          "b7": "dequant_matmul.cu"}


def compile_all(versions):
    """One nvcc per version, all started together; name -> library."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for kind, table in versions.items():
        for tag, spec in table.items():
            src = os.path.join(spec.get("dir", build.CSRC_DIR), SOURCE[kind])
            lib = os.path.join(OUT, f"{kind}_{tag}.so")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS,
                   *spec.get("defs", []), "-o", lib, src]
            procs[(kind, tag)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
        entries = re.findall(r"Compiling entry function '(\S+?)' for.*?"
                             r"(\d+) bytes spill stores.*?Used (\d+) "
                             r"registers", out, flags=re.S)
        print(json.dumps({"build": list(key), "rc": proc.returncode,
                          "registers_spills": [
                              [n[-40:], int(r), int(s)]
                              for n, s, r in entries]}), flush=True)
        if proc.returncode:
            print(out[-4000:], flush=True)
            continue
        libs[key] = ctypes.CDLL(lib)
    return libs


def bind_b1(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paddle_flash_attention_bias_fwd.argtypes = \
        [p] * 5 + [i] * 5 + [i] * 3 + [f, i, i, i, p]
    lib.paddle_flash_attention_bias_fwd.restype = i
    lib.paddle_flash_cuda_error_string.argtypes = [i]
    lib.paddle_flash_cuda_error_string.restype = ctypes.c_char_p
    fab._library = lambda: lib


def bind_bwd(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 5 + [i] * 3 + [f, i, i, i, p]
    lib.paddle_flash_attention_bwd_dq.argtypes = [p] * 8 + tail
    lib.paddle_flash_attention_bwd_dq.restype = i
    lib.paddle_flash_attention_bwd_dkv.argtypes = [p] * 9 + tail
    lib.paddle_flash_attention_bwd_dkv.restype = i
    lib.paddle_flash_bwd_cuda_error_string.argtypes = [i]
    lib.paddle_flash_bwd_cuda_error_string.restype = ctypes.c_char_p
    fa._bwd_library = lambda: lib


def bwd_rows(gen, dev, libs, only, flush):
    """B3 and B4 versions on chip_smoke's training cases, beside SDPA's
    backward (dq, dk and dv in one call)."""
    for case in cs.TRAIN_FLASH_CASES:
        label, b, h, s, d, dtype, mask_kind, causal = case
        if only and label not in only:
            continue
        q, k, v, mask = cs.flash_case(gen, dev, b, h, s, d, dtype, mask_kind)
        do = torch.randn(b, h, s, d, generator=gen).to(q.dtype).to(dev)
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention_fwd(q, k, v, mask, scale, causal)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, mask, do, lse, delta, scale, causal)
        ref_dq = fa.flash_attention_bwd_dq_reference(*args)
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(*args)
        tol = cs.BWD_TOL[dtype]

        def check(outs, refs):
            """Each output within BWD_TOL of its plain version; the
            largest share of the tolerance."""
            outs = outs if isinstance(outs, tuple) else (outs,)
            for o, r in zip(outs, refs):
                cs.check_close(label, o, r, q.dtype, dtype, tol)
            return max(cs.tolerance_share(o, r, dtype, tol)
                       for o, r in zip(outs, refs))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal, scale=scale)
        sdpa = lambda: torch.autograd.grad(  # noqa: E731
            sdpa_out, leaves, do, retain_graph=True)
        row = {"sdpa_bwd": [cs.cuda_ms(sdpa, flush), profiler_us(sdpa)]}
        for (kind, tag), lib in libs.items():
            if kind == "bwd":
                bind_bwd(lib)
                row[tag] = {
                    "dq": measure(lambda: fa.flash_attention_bwd_dq(*args),
                                  lambda o: check(o, (ref_dq,)), flush),
                    "dkv": measure(lambda: fa.flash_attention_bwd_dkv(*args),
                                   lambda o: check(o, (ref_dk, ref_dv)),
                                   flush)}
        del sdpa_out, leaves
        print(json.dumps({"bwd": label, **row}), flush=True)


def b7_call(lib, spec, x, q, scale):
    """A call of one B7 version on (x, q, scale)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paddle_dequant_cuda_error_string.argtypes = [i]
    lib.paddle_dequant_cuda_error_string.restype = ctypes.c_char_p
    if not spec.get("old_api"):
        lib.paddle_dequant_matmul.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.paddle_dequant_matmul.restype = i
        qo._library = lambda: lib
        return lambda: qo.dequant_matmul(x, q, scale)
    lib.paddle_dequant_matmul.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.paddle_dequant_matmul.restype = i
    m, k = x.shape
    n = q.shape[1]

    def call():
        out = torch.empty(m, n, dtype=x.dtype, device=x.device)
        rc = lib.paddle_dequant_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, qo._X_CODES[x.dtype], qo._w_codes()[q.dtype],
            qo._X_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"B7 launch failed: CUDA error {rc}")
        return out
    return call


def profiler_us(fn, reps=10):
    """Mean device microseconds of fn's kernels, L2 warm."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(cs.device_time_by_kernel(prof).values()) / reps


def measure(fn, check, flush):
    try:
        share = check(fn())
        return [cs.cuda_ms(fn, flush), profiler_us(fn), share]
    except Exception as e:  # a failed version is reported, not fatal
        return "FAIL " + repr(e)[:300]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b1", default="{}", help="B1 versions (JSON)")
    ap.add_argument("--bwd", default="{}", help="B3/B4 versions (JSON)")
    ap.add_argument("--b7", default="{}", help="B7 versions (JSON)")
    ap.add_argument("--only", default="", help="comma-separated cases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    versions = {"b1": json.loads(args.b1), "bwd": json.loads(args.bwd),
                "b7": json.loads(args.b7)}
    only = set(filter(None, args.only.split(",")))
    cs.phase_device()
    libs = compile_all(versions)
    dev = torch.device("cuda", 0)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cs.warm_card(dev)
    gen = torch.Generator().manual_seed(0)
    for label, b, h, s, d, dtype, bias_kind, causal in cs.FLASH_CASES:
        if dtype != "bfloat16" or (only and label not in only):
            continue
        q, k, v, bias = cs.flash_case(gen, dev, b, h, s, d, dtype, bias_kind)
        kw = dict(sm_scale=1.0 / math.sqrt(d), causal=causal)
        ref = fab.flash_attention_bias_reference(q, k, v, bias, **kw)

        def check(out):
            cs.check_close(label, out, ref, q.dtype, dtype)
            return cs.tolerance_share(out, ref, dtype)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=bias, is_causal=causal, scale=kw["sm_scale"])
        row = {"sdpa": [cs.cuda_ms(sdpa, l2.zero_), profiler_us(sdpa)]}
        for (kind, tag), lib in libs.items():
            if kind == "b1":
                bind_b1(lib)
                row[tag] = measure(
                    lambda: fab.flash_attention_bias(q, k, v, bias, **kw),
                    check, l2.zero_)
        print(json.dumps({"b1": label, **row}), flush=True)
    bwd_rows(gen, dev, libs, only, l2.zero_)
    for label, m, k, n, dtype, mode in cs.DEQUANT_CASES:
        if only and label not in only:
            continue
        x, q, scale = cs.dequant_case(gen, dev, m, k, n, dtype, mode)
        ref = qo.dequant_matmul_reference(x, q, scale)
        w = qo.dequantize_weight(q, scale, 1, x.dtype)

        def check(out):
            return cs.check_dequant(label, out, ref, x, q, scale)[1]
        lib_call = lambda: torch.matmul(x, w)  # noqa: E731
        row = {"library": [cs.cuda_ms(lib_call, l2.zero_),
                           profiler_us(lib_call)]}
        for (kind, tag), lib in libs.items():
            if kind == "b7":
                row[tag] = measure(
                    b7_call(lib, versions["b7"][tag], x, q, scale), check,
                    l2.zero_)
        print(json.dumps({"b7": label, **row}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.monotonic()
    rc = main()
    print(json.dumps({"seconds": time.monotonic() - t0}))
    sys.exit(rc)
