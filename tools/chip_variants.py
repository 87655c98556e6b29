#!/usr/bin/env python3
"""Time versions of B1/B2, B3/B4, B5/B6 and B7 side by side on one CUDA card.

Each version is a kernel source (``flash_attention.cu`` for B1 and B2,
``flash_attention_bwd.cu`` for B3 and B4, ``paged_attention.cu`` for B5
and B6, ``dequant_matmul.cu`` for B7) in
a directory of its own, built with the port's flags
(``paddle_tpu_torch/native/build.py``) plus any ``-D`` flags given, into a
library of its own.  The wrappers in ``paddle_tpu_torch/ops`` are pointed
at each library in turn, and every case of ``chip_smoke.FLASH_CASES`` (B1),
every case of ``chip_smoke.TRAIN_FLASH_CASES`` (B2; and B3 and B4, on the
operands of the checkout's B2), every case of ``chip_smoke.paged_cases``
(B5, B6) and every case of ``chip_smoke.DEQUANT_CASES`` runs through each
version on the same inputs:
checked against the plain version with ``chip_smoke``'s tolerances and
timed by ``chip_smoke.cuda_ms`` (L2 flushed, card time only) and by
``torch.profiler`` (kernel time, L2 warm), beside the library call.
Versions compared in one run share a card, a host and inputs.

    python3 tools/chip_variants.py \\
        --b1 '{"parent": {"dir": "_parent/csrc"}, "change": {}}' \\
        --bwd '{"parent": {"dir": "_parent/csrc"}, "change": {}}' \\
        --b7 '{"parent": {"dir": "_parent/csrc", "old_api": true},
               "change": {}}' \
        --paged '{"parent": {"dir": "_parent/csrc", "old_api": true},
                  "change": {}}'

where ``_parent/csrc`` holds the earlier sources, e.g. from
``git archive HEAD~1 paddle_tpu_torch/csrc``.  ``{}`` is the checkout's
own source; ``"defs": ["-DNAME=1"]`` adds compiler flags; ``"old_api"``
calls B7's entry point as it was before it took a split-K workspace, and
B5's and B6's as they were before they took a workspace and a split plan;
``"plan": {"CHUNK_ROUNDS": 2}`` sets constants of
``ops/paged_attention.py``'s split plan while that version runs;
``"check": false`` times a B5/B6 version without holding it to the plain
version (an ablation that computes something else).
Prints one JSON line per case and kernel: ``[cuda_ms, profiler_us, share
of the tolerance]`` per version.
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
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops import quant_ops as qo  # noqa: E402

OUT = os.path.join(build.OUT_DIR, "variants")
SOURCE = {"b1": "flash_attention.cu", "bwd": "flash_attention_bwd.cu",
          "paged": "paged_attention.cu", "b7": "dequant_matmul.cu"}


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


def bind_b2(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paddle_flash_attention_fwd_lse.argtypes = \
        [p] * 6 + [i] * 5 + [i] * 3 + [f, i, i, i, p]
    lib.paddle_flash_attention_fwd_lse.restype = i
    lib.paddle_flash_cuda_error_string.argtypes = [i]
    lib.paddle_flash_cuda_error_string.restype = ctypes.c_char_p
    fa._fwd_lse_library = lambda: lib


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


def train_rows(gen, dev, libs, only, flush):
    """B2 versions on chip_smoke's training cases, beside SDPA's forward;
    B3 and B4 versions on the same cases, on the operands of the
    checkout's B2, beside SDPA's backward (dq, dk and dv in one call)."""
    own_b2 = fa._fwd_lse_library
    for case in cs.TRAIN_FLASH_CASES:
        label, b, h, s, d, dtype, mask_kind, causal = case
        if only and label not in only:
            continue
        q, k, v, mask = cs.flash_case(gen, dev, b, h, s, d, dtype, mask_kind)
        do = torch.randn(b, h, s, d, generator=gen).to(q.dtype).to(dev)
        scale = 1.0 / math.sqrt(d)
        fwd_args = (q, k, v, mask, scale, causal)
        ref_out, ref_lse = fa.flash_attention_fwd_reference(*fwd_args)

        def check_fwd(got):
            cs.check_close(label, got[0], ref_out, q.dtype, dtype)
            cs.check_close(label + " lse", got[1], ref_lse, torch.float32,
                           "float32")
            return max(cs.tolerance_share(got[0], ref_out, dtype),
                       cs.tolerance_share(got[1], ref_lse, "float32"))
        sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, is_causal=causal, scale=scale)
        if any(kind == "b1" for kind, _tag in libs):
            row = {"sdpa": [cs.cuda_ms(sdpa_fwd, flush),
                            profiler_us(sdpa_fwd)]}
            for (kind, tag), lib in libs.items():
                if kind == "b1":
                    bind_b2(lib)
                    row[tag] = measure(
                        lambda: fa.flash_attention_fwd(*fwd_args), check_fwd,
                        flush)
            print(json.dumps({"b2": label, **row}), flush=True)
            fa._fwd_lse_library = own_b2
        out, lse = fa.flash_attention_fwd(*fwd_args)
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


def paged_call(lib, spec, kernel, args, kw):
    """A call of one B5/B6 version (``kernel``) on ``args``: through the
    checkout's wrapper, or (``old_api``) through the entry points that
    took no workspace and no split plan."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paddle_cuda_error_string.argtypes = [i]
    lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    decode = kernel == "paged_decode_attention"
    if not spec.get("old_api"):
        lib.paddle_paged_decode_attention.argtypes = \
            [p] * 9 + [i] * 7 + [f, i, i, p]
        lib.paddle_paged_chunk_attention.argtypes = \
            [p] * 9 + [i] * 9 + [f, i, i, p]
        pa._library = lambda: lib
        fn = pa.paged_decode_attention if decode else pa.paged_chunk_attention
        plan = spec.get("plan", {})

        def call():
            saved = {k: getattr(pa, k) for k in plan}
            for k, v in plan.items():
                setattr(pa, k, v)
            try:
                return fn(*args, **kw)
            finally:
                for k, v in saved.items():
                    setattr(pa, k, v)
        return call
    entry = (lib.paddle_paged_decode_attention if decode
             else lib.paddle_paged_chunk_attention)
    entry.argtypes = [p] * 8 + [i] * (5 if decode else 6) + [f, i, i, p]
    q, kp, vp, table, lens = args

    def call():
        out = torch.empty_like(q)
        ptr = (lambda t: None if t is None else t.data_ptr())
        rc = entry(ptr(q), ptr(kp), ptr(vp), ptr(kw["k_scales"]),
                   ptr(kw["v_scales"]), ptr(table), ptr(lens), ptr(out),
                   *q.shape, kp.shape[1], table.shape[1],
                   1.0 / math.sqrt(q.shape[-1]), pa._DTYPE_CODES[q.dtype],
                   pa._DTYPE_CODES[kp.dtype],
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
        return out
    return call


def paged_rows(gen, dev, libs, versions, only, flush):
    """B5 and B6 versions on chip_smoke's paged cases, beside SDPA on K/V
    gathered to dense."""
    for label, kernel, c, kv in cs.paged_cases(gen, dev):
        if only and label not in only:
            continue
        q, lens = c["q"], c["row_lengths"]
        decode = kernel == "paged_decode_attention"
        if decode:
            q, lens = q[:, 0].contiguous(), lens[:, 0].contiguous()
            plain = pa.paged_decode_attention_reference
        else:
            plain = pa.paged_chunk_attention_reference
        args = (q, c["k_pages"], c["v_pages"], c["page_table"], lens)
        kw = dict(k_scales=c["k_scales"], v_scales=c["v_scales"])
        ref = plain(*args, **kw)

        def check(out):
            cs.check_close(label, out, ref, q.dtype, kv)
            return cs.tolerance_share(out, ref, kv)
        sq, sk, sv, mask = cs.sdpa_inputs(c, kv)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            sq, sk, sv, attn_mask=mask)
        row = {"sdpa": [cs.cuda_ms(sdpa, flush), profiler_us(sdpa)]}
        for (kind, tag), lib in libs.items():
            if kind == "paged":
                spec = versions["paged"][tag]
                row[tag] = measure(paged_call(lib, spec, kernel, args, kw),
                                   check if spec.get("check", True)
                                   else (lambda _out: None),
                                   flush, by_kernel=True)
        print(json.dumps({"paged": label, **row}), flush=True)


def profiler_by_kernel(fn, reps=10):
    """Mean device microseconds of fn's kernels by name, L2 warm."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {k: v / reps for k, v in cs.device_time_by_kernel(prof).items()}


def profiler_us(fn, reps=10):
    """Mean device microseconds of fn's kernels, L2 warm."""
    return sum(profiler_by_kernel(fn, reps).values())


def measure(fn, check, flush, by_kernel=False):
    """[cuda_ms, profiler µs, share of the tolerance] of one version (and
    its profiler µs by kernel name); a failed version is reported, not
    fatal."""
    try:
        share = check(fn())
        row = [cs.cuda_ms(fn, flush), profiler_us(fn), share]
        if by_kernel:
            row.append({re.sub(r"^void |<.*", "", k): v
                        for k, v in profiler_by_kernel(fn).items()})
        return row
    except Exception as e:  # noqa: BLE001
        return "FAIL " + repr(e)[:300]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b1", default="{}", help="B1/B2 versions (JSON)")
    ap.add_argument("--bwd", default="{}", help="B3/B4 versions (JSON)")
    ap.add_argument("--paged", default="{}", help="B5/B6 versions (JSON)")
    ap.add_argument("--b7", default="{}", help="B7 versions (JSON)")
    ap.add_argument("--only", default="", help="comma-separated cases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    versions = {"b1": json.loads(args.b1), "bwd": json.loads(args.bwd),
                "paged": json.loads(args.paged), "b7": json.loads(args.b7)}
    only = set(filter(None, args.only.split(",")))
    cs.phase_device()
    libs = compile_all(versions)
    dev = torch.device("cuda", 0)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cs.warm_card(dev)
    gen = torch.Generator().manual_seed(0)
    if versions["paged"]:
        paged_rows(gen, dev, libs, versions, only, l2.zero_)
    for label, b, h, s, d, dtype, bias_kind, causal in cs.FLASH_CASES:
        if only and label not in only:
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
    train_rows(gen, dev, libs, only, l2.zero_)
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
