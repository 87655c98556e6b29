#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card and check it.

Run from the repository root, on a host with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device   -- the card's name and power limit, as ``nvidia-smi`` gives them;
2. build    -- the CUDA kernels, compiled from ``paddle_tpu_torch/csrc`` by
               ``paddle_tpu_torch/native/build.py`` (one ``nvcc`` per source,
               all started together): registers and spills by kernel, and
               the tensor-core instructions (HMMA, HGMMA) in each
               tensor-core kernel's machine code;
3. kernels  -- each kernel against its plain PyTorch version on the same
               inputs: the max abs error beside its stated tolerance, and
               CUDA-event times (L2 flushed before each call) of the kernel,
               the plain version and one PyTorch library call computing the
               same function (a yardstick the port never calls), with the
               least time the card could take (bytes or operations over the
               data-sheet peak of the named card).  The paged decode and chunk
               kernels (B5, B6) at the serving path's shapes (S=8 slots, H=8
               heads, D=64, page 16, 64 pages a slot, shuffled page ids),
               against ``F.scaled_dot_product_attention`` on K/V gathered to
               dense; the biased flash-attention forward (B1) at BERT-base's
               shape (B=32, H=12, S=128, D=64, key mask) in bfloat16 and
               float32, with a full [B, H, S, S] bias, unbiased and causal,
               at S=512, at D=128 and at D=256 (bfloat16 runs the
               tensor-core kernel, float32 the CUDA-core one), against
               ``F.scaled_dot_product_attention`` with the bias as
               ``attn_mask``, and, untimed, bfloat16 rows whose bias is -inf
               everywhere (out 0); the flash-attention training
               kernels (B2 forward with lse, B3 dq, B4 dk/dv) at the unfused
               path's shape (B=32, H=12, S=128, D=64, float32, key mask) and
               in bfloat16, with a full [B, H, S, S] mask, unmasked and
               causal, at S=512 and at D=128 (both in float32 and bfloat16)
               and at D=256 in float32: B2 against SDPA's forward, B3 and B4
               together against ``torch.autograd.grad`` through SDPA (one
               call gives dq, dk and dv), their bound in float32 the tensor
               cores' (the bfloat16 products of the split) beside the float32
               CUDA-core figure; and, untimed, rows whose mask is -inf
               everywhere (denominator 0: out 0, lse -1e30, finite
               gradients); the dequant-fused matmul (B7) at the served
               BERT's shapes (FFN up and down and the q/k/v/output
               projections at batch 32, FFN up at batch 1, the pooler and
               the 2-way NSP head) and a ragged one, float32 x with int8
               and fp8 carriers and bfloat16 x, against ``torch.matmul`` on
               the weight dequantized beforehand (what the unquantized
               program runs), its bound the least work known to give the
               product on the tensor cores (three bfloat16 products for
               float32 x, one for bfloat16) beside the float32 CUDA-core
               figure; and, untimed, an all-zero output channel and rows of
               x holding +-inf and NaN (the plain version's IEEE results).
               Each row reports its error's share of the tolerance;
4. serve    -- the README's serving model at full width (vocab 32000,
               d_model 512, 8 layers, 8 heads, ffn 2048, max_seq_len 1024;
               random weights from a seed) behind ``DecodeServer`` on the
               card: 8 greedy requests of 100-600 prompt tokens, the second
               of two sharing a 256-token prefix submitted after the first
               finished (the prefix-hit suffix path), then a chunked-prefill
               engine (``prefill_chunk_pages=8``) on a 700-token prompt.  The
               paged kernels' launch counters are zeroed just before and read
               just after; streamed logits are held against
               ``recompute_logits``;
5. profile  -- 8 requests under ``torch.profiler``: the device's busy share of
               the window and its time by kernel;
6. train    -- BERT-base pretraining at full width (vocab 30522, hidden 768,
               12 layers, 12 heads, ffn 3072, max_pos 512, seq 128, 20
               predictions a sequence; random weights from the program's
               seed) as ``bench.py``'s ``bench_bert`` drives it, through the
               port: ``bert_base_pretrain_program``, ``decorate(opt,
               use_bf16=True).minimize(loss)``, ``Executor()`` on the card,
               the startup program, a warm ``run_steps(steps=3)``, then timed
               steps, each synced.  Batch 32 (the benchmark's 256 is cut to
               the script's time limit), dropout 0.1, AdamW (lr 1e-4, weight
               decay 0.01), ``FLAGS_flash_attention=always`` so that the fused
               attention op runs B1.  B1's launch counter is zeroed just
               before the timed steps and read just after: 24 a step (12
               attention layers, each run again by its generic gradient);
7. train_profile -- one such step under ``torch.profiler``: the device's busy
               share and its time by kernel, B1's share included, and host
               and device time by op type (each op's lowering in a range of
               its own), which prices the forward that generic gradients
               run again;
8. train_oracle -- float32 (no AMP), dropout 0, batch 8, full width: one
               startup copied into two scopes, 3 steps with B1
               (``FLAGS_flash_attention=always``) and 3 with the plain
               composition (``never``); the per-step losses agree within
               1e-4 relative, B1 ran only in the first, and the loss fell
               (AdamW at lr 1e-5 here, where the steps do not overshoot);
9. train_unfused -- the same model built with the unfused attention chain
               (``use_fused_attention=False``: matmul, mask add, softmax,
               matmul per layer), float32, dropout 0, batch 32, as
               ``bench.py``'s ``bench_flash_attention`` builds it, under
               ``FLAGS_flash_attention=always``: the executor's graph-pass
               pipeline rewrites the 12 chains and their 12 grad chains to
               ``flash_attention`` / ``flash_attention_grad``, whose
               lowering runs B2 forward and B3 + B4 backward.  The three
               launch counters are zeroed just before the timed steps and
               read just after: 24 / 12 / 12 a step (the generic gradient
               replays the forward);
10. train_unfused_profile -- one such step under ``torch.profiler``: device
               time of B2, B3 and B4 and of the ``flash_attention`` /
               ``flash_attention_grad`` op ranges, and their share of busy;
11. train_unfused_oracle -- float32, dropout 0, batch 8, lr 1e-5: one startup
               in three scopes, 3 steps each: the unfused program under
               ``never`` (the chain on ``torch.matmul``), under ``always``
               (B2-B4), and the fused program of phase 6 under ``always``
               (B1); losses pairwise within 1e-4 relative, no B2-B4 launch
               in the ``never`` and fused runs;
12. infer   -- BERT-base at full width as an encoder (vocab 30522, hidden 768,
               12 layers, 12 heads, ffn 3072, max_pos 512, seq 128, batch dim
               -1, dropout 0, fused attention) with the pretraining program's
               NSP head (pooler + 2-way classifier), random weights from the
               program's seed, float32: ``fluid.io.save_inference_model`` to
               a temporary directory, then ``inference.Predictor`` on the card
               under ``FLAGS_flash_attention=always``, in three modes of
               ``FLAGS_weight_quant``: '' (float32 weights on cuBLAS), int8
               and fp8_e4m3 (the weight-quant pass rewrites all 74 matmuls to
               ``dequant_matmul``, B7).  Requests of batch 1, 8 and 32; the
               launch counters are zeroed just before each mode's timed runs
               and read just after: 74 B7 (0 under '') and 12 B1 a run.  The
               int8 sequence output is held within 0.05 * max|float32| of the
               float32 run's (the JAX package's bound); fp8's delta is
               reported;
13. infer_profile -- one batch-32 int8 run under ``torch.profiler``: the
               device's busy share, its time by kernel and B7's share;
14. infer_oracle -- a ``Config().disable_gpu()`` Predictor over the same
               directory runs on the CPU (every kernel's plain version): at
               batch 2, in int8 and fp8, its carriers and scales equal the
               card's bit for bit, and in every mode its outputs agree with
               the card's within ``INFER_ORACLE_TOL``.

Then the kernels line, and last ``{"ok": true, "device": {...}}``.  Any failure
raises, so the script exits non-zero without the last line; without a CUDA
device it exits 1 before doing anything.
"""
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# The served model is float32 and every comparison below holds float32
# results to float32 tolerances: a matmul or convolution dropping to TF32
# (about three decimal digits) must fail them, not pass unnoticed.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.amp import decorate  # noqa: E402
from paddle_tpu_torch.framework import (flags, passes,  # noqa: E402
                                        unique_name)
from paddle_tpu_torch.framework.program import program_guard  # noqa: E402
from paddle_tpu_torch.native import build  # noqa: E402
from paddle_tpu_torch.monitor import stat_get, stat_reset  # noqa: E402
from paddle_tpu_torch.observe import tracer  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import flash_attention_bias as fab  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops import quant_ops as qo  # noqa: E402
from paddle_tpu_torch.serving import (DecodeConfig, DecodeServer,  # noqa: E402
                                      TransformerLM)

SOURCES = {
    "paged_decode_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "paged_chunk_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "flash_attention_bias": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_fwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "dequant_matmul": "paddle_tpu_torch/csrc/dequant_matmul.cu",
}
REPLACES = {
    "paged_decode_attention": "paddle_tpu/ops/pallas_decode_attention.py:71",
    "paged_chunk_attention": "paddle_tpu/ops/pallas_decode_attention.py:232",
    "flash_attention_bias": "paddle_tpu/ops/pallas_attention.py:34",
    "flash_attention_fwd": "paddle_tpu/ops/flash_attention.py:121",
    "flash_attention_bwd_dq": "paddle_tpu/ops/flash_attention.py:215",
    "flash_attention_bwd_dkv": "paddle_tpu/ops/flash_attention.py:250",
    "dequant_matmul": "paddle_tpu/ops/quant_ops.py:325",
}
# Data-sheet peaks (dense): bytes/s of device memory, and operations/s by
# the input type the kernels compute from (float32 on the CUDA cores;
# bfloat16 and int8 on the tensor cores, the fastest the work could run).
CARDS = (  # (name substring, bytes/s, {dtype: ops/s}); first match wins
    ("H100 PCIe", 2.0e12, {"float32": 51e12, "bfloat16": 756e12,
                           "int8": 1513e12}),
    ("H100 NVL", 3.9e12, {"float32": 60e12, "bfloat16": 835e12,
                          "int8": 1670e12}),
    ("H100", 3.35e12, {"float32": 67e12, "bfloat16": 989e12,
                       "int8": 1979e12}),
)
# Tolerances of kernel vs plain version on the same inputs, per element:
# |kernel - plain| <= TOL + REL_TOL * |plain|.  float32 and int8 pools
# (dequantized exactly in float32 by both): the two differ only in summation
# order over at most 1024 positions.  bfloat16 pool and q: both compute in
# float32 from the same bfloat16 inputs and round the result to bfloat16,
# so they may also sit one bfloat16 step apart, and a step is at most 2**-7
# of the value (8 significant bits).
TOL = {"float32": 3e-5, "int8": 3e-5, "bfloat16": 3e-5}
REL_TOL = {"float32": 0.0, "int8": 0.0, "bfloat16": 2.0 ** -7}
# Streamed logits vs the recompute oracle at full width: the same float32
# model through different kernels and matmul shapes, i.e. summation order
# only, compounded over 8 layers.
LOGIT_TOL = 1e-3
S, H, D, PAGE, PPS = 8, 8, 64, 16, 64
# B1 (flash attention with a streamed bias) against its plain version: the
# same rule, TOL + REL_TOL * |plain| per element.  Both sum in float32 from
# the same inputs over at most 512 keys and round once to q's type, so
# float32 results differ by summation order only, and bfloat16 ones also by
# at most one bfloat16 step.
# (label, B, H, S, D, dtype, bias, causal); the first is the main path's call
FLASH_CASES = (
    ("bert_bf16", 32, 12, 128, 64, "bfloat16", "key", False),
    ("bert_f32", 32, 12, 128, 64, "float32", "key", False),
    ("full_bias_bf16", 32, 12, 128, 64, "bfloat16", "full", False),
    ("causal_no_bias_bf16", 32, 12, 128, 64, "bfloat16", "none", True),
    ("S512_bf16", 8, 12, 512, 64, "bfloat16", "key", False),
    ("D128_bf16", 32, 6, 128, 128, "bfloat16", "key", False),
    ("D256_bf16", 32, 3, 128, 256, "bfloat16", "key", False),
)
# B2-B4 (the flash-attention training kernels) against their plain versions,
# which take the same operands (B3 and B4: the kernel's lse and delta).  The
# forward's out and lse are held to B1's rule.  The gradients are sums over
# up to 512 rows or keys of products of O(1) terms, each carrying the few
# ulps of an exp: float32 within 1e-4 absolute, bfloat16 within that plus one
# bfloat16 step of the value.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-4}
# (label, B, H, S, D, dtype, mask, causal); the first is the main path's call
TRAIN_FLASH_CASES = (
    ("unfused_f32", 32, 12, 128, 64, "float32", "key", False),
    ("unfused_bf16", 32, 12, 128, 64, "bfloat16", "key", False),
    ("unfused_full_mask_f32", 32, 12, 128, 64, "float32", "full", False),
    ("unfused_causal_no_mask_bf16", 32, 12, 128, 64, "bfloat16", "none",
     True),
    ("unfused_S512_bf16", 8, 12, 512, 64, "bfloat16", "key", False),
    ("unfused_D128_bf16", 32, 6, 128, 128, "bfloat16", "key", False),
    # the float32 split at the longest sum and at the second head width
    ("unfused_S512_f32", 8, 12, 512, 64, "float32", "key", False),
    ("unfused_D128_f32", 32, 6, 128, 128, "float32", "key", False),
    # D = 256: B3 and B4 keep their CUDA-core design there
    ("unfused_D256_f32", 32, 3, 128, 256, "float32", "key", False),
)
UNFUSED_STEPS = 6
B2_PER_STEP, B3_PER_STEP, B4_PER_STEP = 24, 12, 12  # 12 layers; B2 replayed
# BERT-base pretraining (bench.py's bench_bert, BASELINE config 3) at full
# width; the batch is cut from the benchmark's 256 to the time limit.
BERT_PREDS, TRAIN_BATCH, ORACLE_BATCH = 20, 32, 8
TRAIN_STEPS = 10
B1_PER_STEP = 24   # 12 fused attention ops, each replayed by its gradient
# train oracle: the float32 losses of B1 and of the plain composition, per
# step, within this relative gap (summation order over 3 steps)
ORACLE_RTOL = 1e-4
# At the benchmark's lr (1e-4) the first AdamW steps on one batch overshoot
# (every weight moves by about lr at once) and the loss may rise before it
# falls; the oracle's "the loss fell" check runs at a fine-tuning rate.
ORACLE_LR = 1e-5
# B7 (the dequant-fused matmul) against its plain version (the weight
# dequantized in float32, then a float32 cuBLAS matmul): both multiply the
# same float32 products, the kernel dequantizing each weight element as the
# plain version does, so they differ in summation order over K terms only:
# per element within DEQUANT_TOL * sum_k |x[m, k] * w[k, n]| (about 2**-20,
# 16 float32 ulps of the largest partial sum), plus one bfloat16 step
# (2**-7 * |plain|) where the output is bfloat16.
DEQUANT_TOL = 2.0 ** -20
# (label, M, K, N, x dtype, carrier); the first is the main path's largest
# call (FFN up at batch 32)
DEQUANT_CASES = (
    ("ffn_up_b32_f32_int8", 4096, 768, 3072, "float32", "int8"),
    ("ffn_up_b32_f32_fp8", 4096, 768, 3072, "float32", "fp8_e4m3"),
    ("ffn_up_b32_bf16_int8", 4096, 768, 3072, "bfloat16", "int8"),
    ("ffn_down_b32_f32_int8", 4096, 3072, 768, "float32", "int8"),
    ("qkv_out_b32_f32_int8", 4096, 768, 768, "float32", "int8"),
    ("ffn_up_b1_f32_int8", 128, 768, 3072, "float32", "int8"),
    ("ragged_f32_int8", 100, 300, 70, "float32", "int8"),
    ("pooler_b32_f32_int8", 32, 768, 768, "float32", "int8"),
    ("nsp_b32_f32_fp8", 32, 768, 2, "float32", "fp8_e4m3"),
)
# The served model (infer phases): BERT-base's encoder and NSP head.
INFER_BATCHES, INFER_RUNS = (1, 8, 32), 10
INFER_MODES = ("", "int8", "fp8_e4m3")
B7_PER_RUN, B1_PER_RUN = 74, 12   # 6 matmuls x 12 layers + pooler + nsp_out
# int8 vs float32 sequence output: the JAX package's bound
# (tests/test_quant_inference.py), a fraction of the output's scale
INT8_QUALITY_BOUND = 0.05
# The card's outputs vs the CPU's plain versions on the same saved model
# and the same carriers: float32 summation order (cuBLAS and B7 against the
# CPU's kernels) compounded over 12 layers of post-LayerNorm values of O(1).
INFER_ORACLE_TOL = 1e-3


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_peaks(name):
    for key, bw, ops in CARDS:
        if key in name:
            return bw, ops
    raise RuntimeError(f"no data-sheet peaks for card {name!r}")


# Cycles the card spins (torch.cuda._sleep, about 1 ms) before each timed
# call, while the host enqueues the call: without it a call whose host work
# (argument checks, allocation, the launch) outlasts the flush is timed at
# the host's pace, not the card's.
HOST_COVER_CYCLES = 2_000_000


def cuda_ms(fn, flush, reps=30, warmup=3):
    """Median milliseconds of ``fn`` on the card by CUDA events, with the
    L2 cache flushed before each timed call (in serving, the other layers'
    pools and the weights evict a layer's pages between its calls) and the
    card kept busy while the host enqueues it, so that the events bracket
    the card's work only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def warm_card(dev, seconds=1.0):
    """Keep the card busy until its clocks have left idle: a case timed
    first after an idle spell otherwise runs partly at idle clocks."""
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def phase_device():
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, kind=name,
        count=torch.cuda.device_count())
    return name


def phase_build():
    """Build every kernel library; report, from the compiler's own log,
    each library's kernel count, most registers a thread and spill stores,
    with the (mangled) names of the instances that spill."""
    t0 = time.monotonic()
    paths = build.build_all()
    secs = time.monotonic() - t0
    report = {}
    for name, p in paths.items():
        with open(p + ".log") as f:
            text = f.read()
        entries = re.findall(
            r"Compiling entry function '(\S+?)' for.*?(\d+) bytes spill "
            r"stores.*?Used (\d+) registers", text, flags=re.S)
        if not entries:
            raise RuntimeError(f"no kernel in the build log of {name}")
        report[name] = dict(
            kernels=len(entries),
            max_registers=max(int(r) for _n, _s, r in entries),
            spill_store_bytes=sum(int(s) for _n, s, _r in entries),
            spilling={re.sub(r"^_ZN\d+_GLOBAL__N_\w+?_cu_[0-9a-f]{8}\d+", "",
                             n): int(s)
                      for n, s, _r in entries if int(s)})
    sass = tensor_core_instructions(paths)
    for name, counts in sass.items():
        report[name]["tensor_core_instructions"] = counts
    bare = [k for k, n in sass.get("flash_attention_bwd", {}).items()
            if "_mma_kernel" in k and not n]
    if bare:
        raise RuntimeError(f"tensor-core kernels without HMMA: {bare}")
    log("build", seconds=round(secs, 3), libraries=report)


def tensor_core_instructions(paths):
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in each kernel whose
    name says it runs on the tensor cores, from ``cuobjdump -sass`` of the
    built libraries; {} where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = {}
    for name, p in paths.items():
        text = subprocess.run([tool, "-sass", p], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts = {}
        for fn, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)",
                                   text, flags=re.S):
            short = re.sub(r"^_ZN\d+_GLOBAL__N_\w+?_cu_[0-9a-f]{8}\d+", "",
                           fn)
            if "mma" in short:
                counts[short] = len(re.findall(r"\bH(?:G)?MMA\b", body))
        out[name] = counts
    return out


def make_case(gen, dev, rows_per_slot, row_lengths, q_dtype, kv):
    """Random q [S, R, H, D], pools of S*PPS+1 pages with shuffled ids."""
    s = row_lengths.shape[0]
    n_pages = s * PPS + 1
    table = (torch.randperm(n_pages - 1, generator=gen) + 1) \
        .reshape(s, PPS).to(torch.int32)
    q = torch.randn(s, rows_per_slot, H, D, generator=gen).to(q_dtype)
    kf = torch.randn(n_pages, PAGE, H, D, generator=gen)
    vf = torch.randn(n_pages, PAGE, H, D, generator=gen)
    ks = vs = None
    if kv == "int8":
        from paddle_tpu_torch.serving.kv_cache import quantize_kv

        kp, ks = quantize_kv(kf)
        vp, vs = quantize_kv(vf)
    else:
        dt = getattr(torch, kv)
        kp, vp = kf.to(dt), vf.to(dt)
    to = (lambda t: None if t is None else t.to(dev).contiguous())
    return dict(q=to(q), k_pages=to(kp), v_pages=to(vp), page_table=to(table),
                row_lengths=to(row_lengths.to(torch.int32)), k_scales=to(ks),
                v_scales=to(vs))


def case_bound(c, kv, peaks):
    """Least time for the work of one call: each input read once (q, the
    live K/V -- and scales -- of each slot up to its widest row, the live
    page-table entries, the lengths), the output written once; operations
    4*H*D per live (row, position) pair (QK and PV, multiply-add each)."""
    bw, ops_rate = peaks
    q, lens = c["q"], c["row_lengths"].long().clamp(max=PAGE * PPS)
    widest = lens.max(dim=1).values
    kv_elt = c["k_pages"].element_size()
    per_pos = 2 * H * D * kv_elt + (2 * H * 4 if kv == "int8" else 0)
    nbytes = (2 * q.numel() * q.element_size() + int(widest.sum()) * per_pos
              + int(((widest + PAGE - 1) // PAGE).sum()) * 4
              + lens.numel() * 4)
    ops = 4 * H * D * int(lens.sum())
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / ops_rate[kv] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_inputs(c, kv):
    """The yardstick's inputs: K/V gathered to dense [S, H, T, D] (int8
    dequantized), q [S, H, R, D], a boolean mask [S, 1, R, T]."""
    k = pa._gather_dequant(c["k_pages"], c["k_scales"], c["page_table"])
    v = pa._gather_dequant(c["v_pages"], c["v_scales"], c["page_table"])
    dt = c["q"].dtype
    k, v = k.to(dt).transpose(1, 2).contiguous(), \
        v.to(dt).transpose(1, 2).contiguous()
    q = c["q"].transpose(1, 2).contiguous()
    t = torch.arange(k.shape[2], device=k.device)
    mask = (t[None, None, :] < c["row_lengths"].long()[:, :, None])[:, None]
    return q, k, v, mask


def check_close(label, out, ref, want_dtype, kind, tol=None):
    """Max abs error of a kernel's output against its plain version's;
    raises beyond ``tol + REL_TOL[kind] * |plain|`` per element (``tol``
    is ``TOL[kind]`` unless given)."""
    tol = TOL[kind] if tol is None else tol
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != want_dtype:
        raise RuntimeError(f"{label}: output {tuple(out.shape)} {out.dtype},"
                           f" want {tuple(ref.shape)} {want_dtype}")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    excess = float((diff - REL_TOL[kind] * ref.float().abs()).max())
    if not math.isfinite(err) or excess > tol:
        raise RuntimeError(f"{label}: kernel vs plain differ by {err} (max "
                           f"abs), beyond {tol} + {REL_TOL[kind]}"
                           f"*|plain|")
    return err


def tolerance_share(out, ref, kind, tol=None):
    """The largest |kernel - plain| over its allowance TOL + REL_TOL *
    |plain| (``tol`` instead of TOL[kind] if given): 1 is the limit."""
    tol = TOL[kind] if tol is None else tol
    diff = (out.float() - ref.float()).abs()
    return float((diff / (tol + REL_TOL[kind] * ref.float().abs())).max())


def run_case(label, kernel, c, kv, peaks, flush):
    decode = kernel == "paged_decode_attention"
    args = dict(c)
    lens = args.pop("row_lengths")
    q = args.pop("q")
    if decode:
        q, lens = q[:, 0].contiguous(), lens[:, 0].contiguous()
        fn = pa.paged_decode_attention
        plain = pa.paged_decode_attention_reference
    else:
        fn = pa.paged_chunk_attention
        plain = pa.paged_chunk_attention_reference
    out = fn(q, args["k_pages"], args["v_pages"], args["page_table"], lens,
             k_scales=args["k_scales"], v_scales=args["v_scales"])
    ref = plain(q, args["k_pages"], args["v_pages"], args["page_table"], lens,
                k_scales=args["k_scales"], v_scales=args["v_scales"])
    err = check_close(label, out, ref, q.dtype, kv)
    kw = dict(k_scales=args["k_scales"], v_scales=args["v_scales"])
    ms = cuda_ms(lambda: fn(q, args["k_pages"], args["v_pages"],
                            args["page_table"], lens, **kw), flush)
    plain_ms = cuda_ms(lambda: plain(q, args["k_pages"], args["v_pages"],
                                     args["page_table"], lens, **kw), flush)
    sq, sk, sv, mask = sdpa_inputs(c, kv)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask), flush)
    bound_ms, bound_by = case_bound(c, kv, peaks)
    row = dict(case=label, kernel=kernel, pool=kv, q=str(q.dtype)[6:],
               shape=list(c["q"].shape), max_abs_err=err, tolerance=TOL[kv],
               rel_tolerance=REL_TOL[kv],
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    log("kernels", **row)
    return row


def phase_kernels(name):
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    peaks = card_peaks(name)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = l2.zero_
    warm_card(dev)
    clocks = "clocks.sm,power.draw,temperature.gpu"
    log("clocks", at="kernels start", **{clocks: nvidia_smi(clocks)})
    decode_lens = torch.tensor([1, 15, 16, 17, 500, 1024, 250, 777])
    rows = []
    for kv, qd in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                   ("int8", torch.float32)):
        c = make_case(gen, dev, 1, decode_lens[:, None], qd, kv)
        rows.append(run_case(f"decode_{kv}", "paged_decode_attention", c,
                             kv, peaks, flush))
    chunk16 = (496 + torch.arange(1, 17))[None]          # one chunk
    prefill = torch.arange(1, 1025)[None]                # whole prompt
    verify = decode_lens.clamp(max=1020)[:, None] + torch.arange(4)[None]
    for label, lens, kv in (("chunk_S1_R16", chunk16, "float32"),
                            ("chunk_S1_R1024", prefill, "float32"),
                            ("chunk_S8_R4", verify, "float32"),
                            ("chunk_S8_R4_int8", verify, "int8")):
        c = make_case(gen, dev, lens.shape[1], lens, torch.float32, kv)
        rows.append(run_case(label, "paged_chunk_attention", c, kv, peaks,
                             flush))
    for case in FLASH_CASES:
        rows.append(run_flash_case(gen, dev, case, peaks, flush))
    for case in TRAIN_FLASH_CASES:
        rows += run_train_flash_case(gen, dev, case, peaks, flush)
    check_dead_rows(gen, dev)
    check_b1_dead_rows_bf16(gen, dev)
    for case in DEQUANT_CASES:
        rows.append(run_dequant_case(gen, dev, case, peaks, flush))
    check_zero_channel(gen, dev)
    check_non_finite_x(gen, dev)
    del l2
    log("clocks", at="kernels end", **{clocks: nvidia_smi(clocks)})
    return rows


def phase_serve():
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)
    model = TransformerLM(vocab_size=32000, d_model=512, num_layers=8,
                          num_heads=8, ffn_dim=2048, max_seq_len=1024,
                          device=dev)
    weights = model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    prefix = rng.randint(1, 32000, 256).tolist()
    prompts = [rng.randint(1, 32000, n).tolist()
               for n in (100, 180, 260, 340, 420, 600)]
    shared_a = prefix + rng.randint(1, 32000, 90).tolist()
    shared_b = prefix + rng.randint(1, 32000, 150).tolist()
    long_prompt = rng.randint(1, 32000, 700).tolist()
    kw = dict(max_new_tokens=32, record_logits=True)
    srv = DecodeServer(model, weights, DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16)).start()
    try:
        # one short request first: the numbers below are of a warm
        # process (cuBLAS handles, the kernel library, allocator pools)
        srv.submit(rng.randint(1, 32000, 64).tolist(),
                   max_new_tokens=4).result(timeout=600)
        torch.cuda.synchronize()
        flags.set_flags({"enable_tracer": True})
        tracer.clear()
        pa.reset_launch_counts()    # the main path's counts start here
        t0 = time.monotonic()
        reqs = [srv.submit(p, **kw) for p in prompts]
        req_a = srv.submit(shared_a, **kw)
        req_a.result(timeout=600)   # registers the prefix pages
        req_b = srv.submit(shared_b, **kw)
        for r in reqs + [req_b]:
            r.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        spans = tracer.snapshot()
        stats = srv.stats()
    finally:
        srv.stop()
    chunked = DecodeServer(model, None, DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16,
        prefill_chunk_pages=8)).start()
    try:
        req_long = chunked.submit(long_prompt, **kw)
        req_long.result(timeout=600)
        chunked_stats = chunked.stats()
    finally:
        chunked.stop()
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": pa.paged_decode_attention.launches,
                "paged_chunk_attention": pa.paged_chunk_attention.launches}
    flags.set_flags({"enable_tracer": False})

    if stats["cache_hit_rate"] <= 0 or chunked_stats["prefill_chunks"] < 2:
        raise RuntimeError(f"a path was not taken: prefix hit rate "
                           f"{stats['cache_hit_rate']}, prefill chunks "
                           f"{chunked_stats['prefill_chunks']}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{k} was never launched on the main path")
    all_reqs = [(p, r) for p, r in zip(prompts + [shared_a, shared_b],
                                       reqs + [req_a, req_b])]
    all_reqs.append((long_prompt, req_long))
    oracle_err, logit_scale = 0.0, 0.0
    eng = chunked.replicas[0]
    for prompt, r in all_reqs:
        n = len(r.generated)
        if n != 32 or len(r.logits_trace) != n or \
                not all(0 <= t < 32000 for t in r.generated):
            raise RuntimeError(f"bad output: {n} tokens, "
                               f"{len(r.logits_trace)} logit rows")
        for i in sorted({0, n // 2, n - 1}):
            got = r.logits_trace[i]
            if got.shape != (32000,) or not np.isfinite(got).all() \
                    or np.ptp(got) == 0:
                raise RuntimeError(f"logits {got.shape} not finite, or "
                                   f"all equal")
            want = eng.recompute_logits(prompt + r.generated[:i])
            oracle_err = max(oracle_err, float(np.abs(got - want).max()))
            logit_scale = max(logit_scale, float(np.abs(want).max()))
    if oracle_err > LOGIT_TOL:
        raise RuntimeError(f"streamed logits vs recompute_logits: max abs "
                           f"{oracle_err} > {LOGIT_TOL}")
    step_ms = [1e3 * sp.duration for sp in spans
               if sp.name == "serving/decode_step"]
    prefill_ms = [1e3 * sp.duration for sp in spans
                  if sp.name == "serving/decode_prefill"]
    ttft_ms = [1e3 * (r.t_first_token - r.t_enqueue)
               for _p, r in all_reqs[:-1]]
    n_tokens = sum(len(r.generated) for _p, r in all_reqs[:-1])
    log("serve", requests=len(all_reqs), tokens=n_tokens,
        tokens_per_s=n_tokens / wall, wall_s=wall,
        decode_step_p50_ms=float(np.median(step_ms)),
        decode_steps=len(step_ms), ttft_p50_ms=float(np.median(ttft_ms)),
        prefill_p50_ms=float(np.median(prefill_ms)),
        prefills=len(prefill_ms),
        prefix_hit_rate=stats["cache_hit_rate"],
        prefill_chunks=chunked_stats["prefill_chunks"],
        logits_vs_oracle_max_abs=oracle_err, tolerance=LOGIT_TOL,
        oracle_logits_max_abs=logit_scale,
        launches=launches)
    return launches, model


def device_time_by_kernel(prof):
    """Device microseconds by kernel (and copy) name from a profile; the
    card runs one stream here, so the intervals do not overlap.  A
    profiler range also shows on the device's timeline, spanning the
    kernels launched inside it: it is not a kernel, and is left out."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = e.name.replace("(anonymous namespace)::", "")
            key = re.sub(r"\(.*", "", name)[:80]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    return by_name


def phase_profile(model):
    """Where a decode-heavy window's time goes: 8 requests (300-token
    prompts, 24 new tokens) under torch.profiler; the device's busy time
    is the sum of its kernel and copy intervals, against the host clock
    around the window."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 32000, 300).tolist() for _ in range(8)]
    srv = DecodeServer(model, None, DecodeConfig(
        slots=8, max_seq_len=1024, page_size=16)).start()
    try:
        srv.submit(prompts[0][:64], max_new_tokens=2).result(timeout=600)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            reqs = [srv.submit(p, max_new_tokens=24) for p in prompts]
            for r in reqs:
                r.result(timeout=600)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    finally:
        srv.stop()
    by_name = device_time_by_kernel(prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("profile", window_ms=wall_us / 1e3, tokens=8 * 24,
        device_busy_ms=busy_us / 1e3 if busy_us else None,
        device_busy_share=busy_us / wall_us if busy_us else None,
        top_device_ms={k: v / 1e3 for k, v in top})


# ---- B1 and the static-graph training path ----------------------------------


def flash_case(gen, dev, b, h, s, d, dtype, bias):
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(dt).to(dev)
               for _ in range(3))
    if bias == "key":       # BERT's additive key mask: 0 keep, -1e4 pad
        keep = torch.rand(b, 1, 1, s, generator=gen) > 0.1
        bias_t = torch.where(keep, 0.0, -1e4)
    elif bias == "full":
        bias_t = torch.randn(b, h, s, s, generator=gen)
    else:
        bias_t = None
    return q, k, v, None if bias_t is None else bias_t.to(dt).to(dev)


def flash_bound(q, bias, causal, peaks):
    """Least time for one call: q, k, v and the bias (in its natural
    shape) read once, the output written once; 4*D operations (QK and PV,
    multiply-add each) per (query, key) pair the mask leaves."""
    bw, ops_rate = peaks
    b, h, s, d = q.shape
    nbytes = 4 * q.numel() * q.element_size()
    if bias is not None:
        nbytes += bias.numel() * bias.element_size()
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * d * pairs * b * h
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / ops_rate[str(q.dtype)[6:]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_flash_case(gen, dev, case, peaks, flush):
    label, b, h, s, d, dtype, bias_kind, causal = case
    q, k, v, bias = flash_case(gen, dev, b, h, s, d, dtype, bias_kind)
    kw = dict(sm_scale=1.0 / math.sqrt(d), causal=causal)
    out = fab.flash_attention_bias(q, k, v, bias, **kw)
    ref = fab.flash_attention_bias_reference(q, k, v, bias, **kw)
    err = check_close(label, out, ref, q.dtype, dtype)
    share = tolerance_share(out, ref, dtype)
    ms = cuda_ms(lambda: fab.flash_attention_bias(q, k, v, bias, **kw), flush)
    plain_ms = cuda_ms(lambda: fab.flash_attention_bias_reference(
        q, k, v, bias, **kw), flush)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias, is_causal=causal, scale=kw["sm_scale"]),
        flush)
    bound_ms, bound_by = flash_bound(q, bias, causal, peaks)
    row = dict(case=label, kernel="flash_attention_bias", q=dtype,
               shape=[b, h, s, d], bias=bias_kind, causal=causal,
               max_abs_err=err, tolerance=TOL[dtype],
               rel_tolerance=REL_TOL[dtype], err_share_of_tolerance=share,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    log("kernels", **row)
    return row


# The float32 backward (B3, B4) on the tensor cores (D = 64 and 128; D = 256
# keeps the CUDA cores): each float32 product is taken as the bfloat16
# products of the operands' three pieces and of P's and dS's two with
# i + j <= 2 -- 6 for S and for dP, 5 for each second product
# (csrc/flash_attention_bwd.cu).
BWD_F32_PRODUCTS = {"flash_attention_bwd_dq": 6 + 6 + 5,
                    "flash_attention_bwd_dkv": 6 + 6 + 5 + 5}


def train_flash_bounds(q, mask, causal, peaks):
    """Least times for B2, B3 and B4 on one call's operands: name -> (ms,
    "bytes" or "operations", the float32 CUDA-core figure or None).
    Bytes: q, k, v (and do, lse, delta for the backward) and the mask in
    its natural shape read once, each output written once.  Operations per
    (query, key) pair the mask leaves, multiply-add each: 4*D in B2 (QK,
    PV), 6*D in B3 (S, dP, dQ), 8*D in B4 (S, dV, dP, dK), at the peak of
    the inputs' type.  Float32 B3 and B4 at D <= 128 run on the tensor
    cores: their operations are the split's bfloat16 products
    (BWD_F32_PRODUCTS, 2*D each) at the bfloat16 peak, with the float32
    CUDA-core figure (the larger of the bytes and 6*D or 8*D at the
    float32 peak) beside it."""
    bw, ops_rate = peaks
    b, h, s, d = q.shape
    tensor = q.numel() * q.element_size()
    stat = b * h * s * 4                      # lse or delta, float32
    mask_b = 0 if mask is None else mask.numel() * mask.element_size()
    pairs = (s * (s + 1) // 2 if causal else s * s) * b * h
    dtype = str(q.dtype)[6:]
    out = {}
    for name, nbytes, per_pair in (
            ("flash_attention_fwd", 4 * tensor + stat + mask_b, 4 * d),
            ("flash_attention_bwd_dq", 5 * tensor + 2 * stat + mask_b, 6 * d),
            ("flash_attention_bwd_dkv", 6 * tensor + 2 * stat + mask_b,
             8 * d)):
        t_bytes = nbytes / bw * 1e3
        t_ops = per_pair * pairs / ops_rate[dtype] * 1e3
        f32_cuda_core = None
        if dtype == "float32" and name in BWD_F32_PRODUCTS and d <= 128:
            f32_cuda_core = max(t_bytes, t_ops)
            t_ops = BWD_F32_PRODUCTS[name] * 2 * d * pairs \
                / ops_rate["bfloat16"] * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations")) + (f32_cuda_core,)
    return out


def run_train_flash_case(gen, dev, case, peaks, flush):
    """B2, B3 and B4 on one set of operands: each against its plain
    version, timed beside it and beside the library's call."""
    label, b, h, s, d, dtype, mask_kind, causal = case
    q, k, v, mask = flash_case(gen, dev, b, h, s, d, dtype, mask_kind)
    do = torch.randn(b, h, s, d, generator=gen).to(q.dtype).to(dev)
    scale = 1.0 / math.sqrt(d)
    fwd_args = (q, k, v, mask, scale, causal)
    out, lse = fa.flash_attention_fwd(*fwd_args)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(*fwd_args)
    delta = (do.float() * out.float()).sum(-1)
    bwd_args = (q, k, v, mask, do, lse, delta, scale, causal)
    dq = fa.flash_attention_bwd_dq(*bwd_args)
    dk, dv = fa.flash_attention_bwd_dkv(*bwd_args)
    ref_dq = fa.flash_attention_bwd_dq_reference(*bwd_args)
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(*bwd_args)
    tol = BWD_TOL[dtype]
    errs = {
        "flash_attention_fwd": max(
            check_close(label + " out", out, ref_out, q.dtype, dtype),
            check_close(label + " lse", lse, ref_lse, torch.float32,
                        "float32")),
        "flash_attention_bwd_dq": check_close(
            label + " dq", dq, ref_dq, q.dtype, dtype, tol),
        "flash_attention_bwd_dkv": max(
            check_close(label + " dk", dk, ref_dk, q.dtype, dtype, tol),
            check_close(label + " dv", dv, ref_dv, q.dtype, dtype, tol)),
    }
    shares = {
        "flash_attention_fwd": max(
            tolerance_share(out, ref_out, dtype),
            tolerance_share(lse, ref_lse, "float32")),
        "flash_attention_bwd_dq": tolerance_share(dq, ref_dq, dtype, tol),
        "flash_attention_bwd_dkv": max(
            tolerance_share(dk, ref_dk, dtype, tol),
            tolerance_share(dv, ref_dv, dtype, tol)),
    }
    fns = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(*fwd_args),
            lambda: fa.flash_attention_fwd_reference(*fwd_args)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(*bwd_args),
            lambda: fa.flash_attention_bwd_dq_reference(*bwd_args)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(*bwd_args),
            lambda: fa.flash_attention_bwd_dkv_reference(*bwd_args)),
    }
    # the yardsticks: SDPA's forward for B2; for B3 and B4 together, one
    # pull-back through SDPA's graph, which gives dq, dk and dv
    sdpa_kw = dict(attn_mask=mask, is_causal=causal, scale=scale)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, **sdpa_kw), flush)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, do, retain_graph=True), flush)
    del sdpa_out, leaves
    bounds = train_flash_bounds(q, mask, causal, peaks)
    rows = []
    for kernel, (fn, plain) in fns.items():
        bound_ms, bound_by, f32_bound_ms = bounds[kernel]
        backward = kernel != "flash_attention_fwd"
        row = dict(case=label, kernel=kernel, q=dtype, shape=[b, h, s, d],
                   mask=mask_kind, causal=causal, max_abs_err=errs[kernel],
                   tolerance=tol if backward else TOL[dtype],
                   rel_tolerance=REL_TOL[dtype],
                   err_share_of_tolerance=shares[kernel],
                   ms=cuda_ms(fn, flush),
                   plain_ms=cuda_ms(plain, flush),
                   library_ms=lib_bwd if backward else lib_fwd,
                   library="sdpa backward (dq, dk, dv in one call)"
                   if backward else "sdpa forward",
                   bound_ms=bound_ms, bound_by=bound_by)
        if f32_bound_ms is not None:
            row["f32_cuda_core_bound_ms"] = f32_bound_ms
        log("kernels", **row)
        rows.append(row)
    return rows


def check_dead_rows(gen, dev):
    """Rows whose mask is -inf everywhere (softmax denominator 0): B2 must
    give out 0 and lse -1e30 there, and B3/B4 finite gradients with dq 0 on
    those rows, each equal to its plain version within the float32
    tolerances above."""
    b, h, s, d, dead = 2, 2, 128, 64, [5, 77]
    q, k, v, _ = flash_case(gen, dev, b, h, s, d, "float32", "none")
    do = torch.randn(b, h, s, d, generator=gen).to(dev)
    mask = torch.zeros(b, 1, s, s, device=dev)
    mask[:, :, dead, :] = float("-inf")
    scale = 1.0 / math.sqrt(d)
    out, lse = fa.flash_attention_fwd(q, k, v, mask, scale, False)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, mask, scale,
                                                        False)
    delta = (do * out).sum(-1)
    args = (q, k, v, mask, do, lse, delta, scale, False)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    ref_dq = fa.flash_attention_bwd_dq_reference(*args)
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(*args)
    errs = [check_close("dead_rows " + n, x, r, torch.float32, "float32", t)
            for n, x, r, t in (("out", out, ref_out, None),
                               ("lse", lse, ref_lse, None),
                               ("dq", dq, ref_dq, BWD_TOL["float32"]),
                               ("dk", dk, ref_dk, BWD_TOL["float32"]),
                               ("dv", dv, ref_dv, BWD_TOL["float32"]))]
    if not (bool((out[:, :, dead] == 0).all())
            and bool((lse[:, :, dead] == -1e30).all())
            and bool((dq[:, :, dead] == 0).all())):
        raise RuntimeError("dead rows: out, dq not 0 or lse not -1e30")
    log("kernels", case="dead_rows_f32", kernel="flash_attention_fwd+bwd",
        shape=[b, h, s, d], dead_rows=dead,
        max_abs_err_out_lse_dq_dk_dv=errs, out_is_0=True,
        lse_is_minus_1e30=True, dq_is_0=True)


def check_b1_dead_rows_bf16(gen, dev):
    """B1's tensor-core kernel (bfloat16) on rows whose bias is -inf at
    every key (softmax denominator 0): out 0 there, as the TPU kernel's
    l == 0 guard gives, and elsewhere within B1's bfloat16 tolerance of
    B2's plain version, which computes the same function with that guard
    (B1's plain version, a softmax, gives NaN on such rows)."""
    b, h, s, d, dead = 2, 2, 128, 64, [5, 77]
    q, k, v, _ = flash_case(gen, dev, b, h, s, d, "bfloat16", "none")
    bias = torch.zeros(b, 1, s, s, device=dev, dtype=torch.bfloat16)
    bias[:, :, dead, :] = float("-inf")
    scale = 1.0 / math.sqrt(d)
    out = fab.flash_attention_bias(q, k, v, bias, sm_scale=scale)
    ref, _lse = fa.flash_attention_fwd_reference(q, k, v, bias, scale, False)
    err = check_close("dead_rows_bf16 out", out, ref, q.dtype, "bfloat16")
    if not bool((out[:, :, dead] == 0).all()):
        raise RuntimeError("B1 bf16 dead rows: out not 0")
    log("kernels", case="dead_rows_bf16", kernel="flash_attention_bias",
        shape=[b, h, s, d], dead_rows=dead, max_abs_err=err,
        err_share_of_tolerance=tolerance_share(out, ref, "bfloat16"),
        out_is_0=True)


# ---- B7 and the quantized inference path ------------------------------------


def dequant_case(gen, dev, m, k, n, dtype, mode):
    """x [M, K] and a weight [K, N] with a 30x outlier channel, quantized
    on the card as the weight-quant pass does."""
    x = torch.randn(m, k, generator=gen).to(getattr(torch, dtype)).to(dev)
    w = torch.randn(k, n, generator=gen)
    w[:, 0] *= 30.0
    q, scale = qo.quantize_weight(w.to(dev), 1, mode)
    return x, q, scale


def check_dequant(label, out, ref, x, q, scale):
    """Max abs error of B7 against its plain version; raises beyond
    DEQUANT_TOL * sum_k |x w| (+ one bfloat16 step) per element."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != x.dtype:
        raise RuntimeError(f"{label}: output {tuple(out.shape)} {out.dtype},"
                           f" want {tuple(ref.shape)} {x.dtype}")
    w = qo.dequantize_weight(q, scale, 1)
    size = x.float().abs() @ w.abs()
    diff = (out.float() - ref.float()).abs()
    rel = REL_TOL[str(x.dtype)[6:]]
    excess = diff - DEQUANT_TOL * size - rel * ref.float().abs()
    err = float(diff.max())
    if not math.isfinite(err) or float(excess.max()) > 0:
        raise RuntimeError(f"{label}: B7 vs plain differ by {err} (max abs),"
                           f" beyond {DEQUANT_TOL} * sum|x w| + {rel} "
                           f"* |plain|")
    return err, float((diff / (DEQUANT_TOL * size + rel * ref.float().abs()
                               + 1e-30)).max())


def dequant_bound(x, q, scale, peaks):
    """Least time for one call: x, the carrier and the scale read once, the
    output written once; the operations of the least work known to give
    the product on this card at the bfloat16 tensor-core peak.  The 8-bit
    carrier is exact in bfloat16; bfloat16 x needs one product (2*M*K*N
    operations); float32 x needs three (its three bfloat16 pieces carry its
    24 bits): 3*2*M*K*N.  Returns (ms, "bytes" or "operations", and beside
    them the float32 CUDA-core figure: the larger of the bytes and 2*M*K*N
    at the float32 peak)."""
    bw, ops_rate = peaks
    m, k = x.shape
    n = q.shape[1]
    nbytes = (x.numel() * x.element_size() + q.numel() * q.element_size()
              + scale.numel() * 4 + m * n * x.element_size())
    t_bytes = nbytes / bw * 1e3
    pieces = 3 if x.dtype == torch.float32 else 1
    t_ops = pieces * 2 * m * k * n / ops_rate["bfloat16"] * 1e3
    t_f32 = max(t_bytes, 2 * m * k * n / ops_rate[str(x.dtype)[6:]] * 1e3)
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (t_f32,)


def run_dequant_case(gen, dev, case, peaks, flush):
    label, m, k, n, dtype, mode = case
    x, q, scale = dequant_case(gen, dev, m, k, n, dtype, mode)
    out = qo.dequant_matmul(x, q, scale)
    ref = qo.dequant_matmul_reference(x, q, scale)
    err, share = check_dequant(label, out, ref, x, q, scale)
    w = qo.dequantize_weight(q, scale, 1, x.dtype)   # what '' mode holds
    bound_ms, bound_by, f32_bound_ms = dequant_bound(x, q, scale, peaks)
    row = dict(case=label, kernel="dequant_matmul", x=dtype, carrier=mode,
               shape=[m, k, n], max_abs_err=err,
               tolerance=f"{DEQUANT_TOL} * sum|x w| + {REL_TOL[dtype]} "
                         f"* |plain|", err_share_of_tolerance=share,
               ms=cuda_ms(lambda: qo.dequant_matmul(x, q, scale), flush),
               plain_ms=cuda_ms(lambda: qo.dequant_matmul_reference(
                   x, q, scale), flush),
               library_ms=cuda_ms(lambda: torch.matmul(x, w), flush),
               library="torch.matmul on the weight dequantized beforehand "
                       f"({dtype}, TF32 off)",
               bound_ms=bound_ms, bound_by=bound_by,
               f32_cuda_core_bound_ms=f32_bound_ms)
    row["tflops"] = 2 * m * k * n / row["ms"] / 1e9
    log("kernels", **row)
    return row


def check_zero_channel(gen, dev):
    """An all-zero output channel gets a clamped scale of its own and
    dequantizes to exact zeros: B7 writes 0.0 there, in int8 and fp8."""
    for mode in ("int8", "fp8_e4m3"):
        x = torch.randn(64, 96, generator=gen).to(dev)
        w = torch.randn(96, 40, generator=gen)
        w[:, 7] = 0.0
        q, scale = qo.quantize_weight(w.to(dev), 1, mode)
        out = qo.dequant_matmul(x, q, scale)
        ref = qo.dequant_matmul_reference(x, q, scale)
        err, _ = check_dequant("zero_channel_" + mode, out, ref, x, q, scale)
        if float(scale[7]) != float(np.float32(qo.SCALE_EPS)):
            raise RuntimeError(f"zero channel: scale {float(scale[7])}")
        if not bool((out[:, 7] == 0).all()):
            raise RuntimeError(f"zero channel ({mode}): B7 wrote "
                               f"{out[:, 7].abs().max()} where 0 is due")
        log("kernels", case="zero_channel_" + mode, kernel="dequant_matmul",
            shape=[64, 96, 40], max_abs_err=err, zero_channel_exact=True)


def check_non_finite_x(gen, dev):
    """B7 on float32 x holding +inf, -inf and NaN: the kernel splits x into
    bfloat16 pieces, and must give what the plain float32 product gives by
    IEEE rules -- +-inf and NaN in the same places -- and elsewhere agree
    within the tolerance.  The carrier rows that meet those values are +-1
    (no 0 to make inf * 0)."""
    m, k, n = 64, 96, 40
    x = torch.randn(m, k, generator=gen)
    x[0, 5], x[1, 9], x[2, 11] = float("inf"), float("-inf"), float("nan")
    q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    q[[5, 9, 11]] = torch.where(
        torch.rand(3, n, generator=gen) > 0.5, 1, -1).to(torch.int8)
    scale = torch.full((n,), 1e-3)
    x, q, scale = x.to(dev), q.to(dev), scale.to(dev)
    out = qo.dequant_matmul(x, q, scale)
    ref = qo.dequant_matmul_reference(x, q, scale)
    torch.cuda.synchronize()
    rows = [0, 1, 2]
    same_nan = torch.equal(out.isnan(), ref.isnan())
    same_inf = torch.equal(out.isinf(), ref.isinf()) and torch.equal(
        out[ref.isinf()], ref[ref.isinf()])
    kinds = [("inf" if bool(ref[r].isinf().all()) else "nan"
              if bool(ref[r].isnan().all()) else "finite") for r in rows]
    if not (same_nan and same_inf) or kinds != ["inf", "inf", "nan"]:
        raise RuntimeError(f"non-finite x: B7 vs plain differ where the "
                           f"plain version is not finite (rows {kinds})")
    keep = [r for r in range(m) if r not in rows]
    err, share = check_dequant("non_finite_x", out[keep], ref[keep],
                               x[keep], q, scale)
    log("kernels", case="non_finite_x", kernel="dequant_matmul",
        shape=[m, k, n], rows_inf_inf_nan=kinds,
        non_finite_match_plain=True, max_abs_err_finite_rows=err,
        err_share_of_tolerance=share)


def build_bert(batch, amp, dropout, lr=1e-4, fused=True):
    """BERT-base pretraining at full width, as bench.py builds it."""
    from paddle_tpu_torch.text import bert_base_pretrain_program

    with unique_name.guard():
        main, startup, _feeds, loss, opt = bert_base_pretrain_program(
            batch_size=batch, max_preds_per_seq=BERT_PREDS,
            dropout_prob=dropout, lr=lr, use_fused_attention=fused)
        main.random_seed = 1
        with program_guard(main, startup):
            (decorate(opt, use_bf16=True) if amp else opt).minimize(loss)
    return main, startup, loss


def bert_feed(batch, seed, padded_keys=0):
    """bench_bert's synthetic feeds; ``padded_keys`` masks the last keys
    of every other sequence."""
    seq, preds = 128, BERT_PREDS
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 30522, (batch, seq)).astype("int64")
    flat_pos = np.concatenate(
        [b * seq + rng.choice(seq - padded_keys, preds, replace=False)
         for b in range(batch)]).astype("int64")
    mask = np.zeros((batch, 1, 1, seq), "float32")
    if padded_keys:
        mask[::2, :, :, seq - padded_keys:] = -1e4
    return {"input_ids": ids,
            "token_type_ids": np.zeros((batch, seq), "int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "input_mask": mask, "masked_flat_pos": flat_pos,
            "masked_labels": ids.reshape(-1)[flat_pos].reshape(-1, 1),
            "masked_weights": np.ones((batch * preds, 1), "float32"),
            "nsp_labels": rng.randint(0, 2, (batch, 1)).astype("int64")}


def phase_train():
    flags.set_flags({"flash_attention": "always"})
    t0 = time.monotonic()
    main, startup, loss = build_bert(TRAIN_BATCH, amp=True, dropout=0.1)
    build_s = time.monotonic() - t0
    exe = pt.Executor()
    scope = pt.framework.Scope()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.monotonic() - t0
    feed = bert_feed(TRAIN_BATCH, seed=0)
    t0 = time.monotonic()
    warm = exe.run_steps(main, feed=feed, fetch_list=[loss], scope=scope,
                         steps=3)[0]
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    fab.reset_launch_count()    # the main path's count starts here
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    launches = fab.flash_attention_bias.launches
    losses = [float(x) for x in warm.float().cpu().ravel()] + losses
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"BERT losses not finite: {losses}")
    if launches != B1_PER_STEP * TRAIN_STEPS:
        raise RuntimeError(f"B1 launched {launches} times in {TRAIN_STEPS} "
                           f"steps, want {B1_PER_STEP} a step")
    p50 = float(np.median(step_ms))
    log("train", model="bert-base", batch=TRAIN_BATCH, seq=128,
        amp="bfloat16", dropout=0.1, steps=TRAIN_STEPS,
        step_ms_p50=p50, step_ms=step_ms,
        tokens_per_s=TRAIN_BATCH * 128 / (p50 / 1e3),
        program_ops=len(main.global_block.ops), build_s=build_s,
        startup_s=startup_s, warm_run_steps_3_s=warm_s, losses=losses,
        b1_launches=launches, b1_launches_per_step=launches / TRAIN_STEPS,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, (exe, main, feed, loss, scope)


def op_ranges():
    """Wrap every op's lowering, for one profiled step, in a profiler range
    named ``op/<type>``, so that host and device time add up by op type.
    Returns the undo.  (The ranges cost host time of their own.)"""
    from torch.profiler import record_function

    from paddle_tpu_torch.framework import executor

    real = executor.get_lowering

    def labelled(op_type):
        rule = real(op_type)

        def run(ctx, op):
            with record_function("op/" + op_type):
                rule(ctx, op)
        return run

    executor.get_lowering = labelled
    return lambda: setattr(executor, "get_lowering", real)


def phase_train_profile(run, phase="train_profile",
                        kernels=(("b1", "flash_fwd_mma_kernel"),),
                        op_types=()):
    """One BERT-base step or inference run (``run()``) under
    torch.profiler: the device's busy share of its host time, its time by
    kernel (``kernels``: (label, name part) of the hand-written kernels it
    must have run), and host and device time by op type (``op_types``:
    types reported on their own).  A ``<type>_grad`` op without a
    lowering of its own takes the generic gradient, which runs
    ``<type>``'s forward again under autograd: the time of those forward
    types is what the replay repeats.
    Kernels that ``torch.autograd.grad`` launches run on the autograd
    engine's thread, outside the op ranges: they count by kernel name
    only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.framework.lowering import LOWERINGS

    torch.cuda.synchronize()
    undo = op_ranges()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    finally:
        undo()
    by_name = device_time_by_kernel(prof)
    busy_us = sum(by_name.values())
    ours = {}
    for label, part in kernels:
        ours[label] = sum(t for k, t in by_name.items() if part in k)
        if not ours[label]:
            raise RuntimeError(f"the profiled step ran no {part}")
    host, dev, count = {}, {}, {}
    for e in prof.events():   # the ranges on the host's timeline
        if e.device_type == DeviceType.CPU and e.name.startswith("op/"):
            t = e.name[3:]
            host[t] = host.get(t, 0.0) + e.cpu_time_total / 1e3
            dev[t] = dev.get(t, 0.0) + e.device_time_total / 1e3
            count[t] = count.get(t, 0) + 1
    replayed = {t[:-len("_grad")] for t in count
                if t.endswith("_grad") and t not in LOWERINGS}
    by_type = {t: [count[t], host[t], dev[t]]
               for t in sorted(host, key=lambda t: -host[t])}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(phase, step_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / wall_us,
        **{f"{label}_device_ms": t / 1e3 for label, t in ours.items()},
        **{f"{label}_share_of_busy": t / busy_us
           for label, t in ours.items()},
        **{f"op_{t}_count_host_ms_device_ms": by_type.get(t)
           for t in op_types},
        **{f"op_{t}_share_of_busy": dev.get(t, 0.0) * 1e3 / busy_us
           for t in op_types},
        kernels=len(by_name),
        top_device_ms={k: v / 1e3 for k, v in top},
        ops_host_ms=sum(host.values()), ops_device_ms=sum(dev.values()),
        generic_grad_host_ms=sum(host[t + "_grad"] for t in replayed),
        generic_grad_device_ms=sum(dev[t + "_grad"] for t in replayed),
        replayed_forward_host_ms=sum(host[t] for t in replayed),
        replayed_forward_device_ms=sum(dev[t] for t in replayed),
        by_op_type_count_host_ms_device_ms=by_type)


def phase_train_oracle():
    main, startup, loss = build_bert(ORACLE_BATCH, amp=False, dropout=0.0,
                                     lr=ORACLE_LR)
    exe = pt.Executor()
    first = pt.framework.Scope()
    exe.run(startup, scope=first)
    second = copy_scope(first)
    feed = bert_feed(ORACLE_BATCH, seed=1, padded_keys=16)
    runs = {}
    try:
        for mode, scope in (("always", first), ("never", second)):
            flags.set_flags({"flash_attention": mode})
            before = fab.flash_attention_bias.launches
            out = exe.run_steps(main, feed=feed, fetch_list=[loss],
                                scope=scope, steps=3, return_numpy=True)[0]
            runs[mode] = ([float(x) for x in out.ravel()],
                          fab.flash_attention_bias.launches - before)
    finally:
        flags.set_flags({"flash_attention": "auto"})
    (flash, n_flash), (plain, n_plain) = runs["always"], runs["never"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(flash, plain))
    log("train_oracle", batch=ORACLE_BATCH, dtype="float32", steps=3,
        losses_b1=flash, losses_plain=plain, max_rel_gap=gap,
        tolerance=ORACLE_RTOL, b1_launches=[n_flash, n_plain])
    if not all(math.isfinite(x) for x in flash + plain) or gap > ORACLE_RTOL:
        raise RuntimeError(f"B1 vs plain losses {flash} vs {plain}: "
                           f"relative gap {gap} > {ORACLE_RTOL}")
    if n_flash != 3 * B1_PER_STEP or n_plain != 0:
        raise RuntimeError(f"B1 launches {n_flash} (want {3 * B1_PER_STEP})"
                           f" with 'always', {n_plain} (want 0) with 'never'")
    if not (flash[2] < flash[0] and plain[2] < plain[0]):
        raise RuntimeError(f"the loss did not fall: {flash}, {plain}")


def exe_run(state):
    exe, main, feed, loss, scope = state
    return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def copy_scope(scope):
    out = pt.framework.Scope()
    for n in scope.local_var_names():
        v = scope.get_var(n)
        if isinstance(v, torch.Tensor):
            out.set_var(n, v.clone())
    return out


def unfused_launches():
    return [f.launches for f in fa.KERNEL_WRAPPERS]


def phase_train_unfused():
    """The main path of the unfused slice: float32, dropout 0, the unfused
    chain rewritten by the graph passes, B2-B4 in every layer."""
    flags.set_flags({"flash_attention": "always"})
    t0 = time.monotonic()
    main, startup, loss = build_bert(TRAIN_BATCH, amp=False, dropout=0.0,
                                     fused=False)
    build_s = time.monotonic() - t0
    exe = pt.Executor()
    scope = pt.framework.Scope()
    torch.cuda.reset_peak_memory_stats()
    exe.run(startup, scope=scope)
    feed = bert_feed(TRAIN_BATCH, seed=0, padded_keys=16)
    for name in ("pass_flash_attention_fused",
                 "pass_flash_attention_grad_fused"):
        stat_reset(name)
    t0 = time.monotonic()
    warm = exe.run_steps(main, feed=feed, fetch_list=[loss], scope=scope,
                         steps=2)[0]
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    rewritten = [stat_get("pass_flash_attention_fused"),
                 stat_get("pass_flash_attention_grad_fused")]
    fa.reset_launch_counts()    # the main path's counts start here
    step_ms, losses = [], []
    for _ in range(UNFUSED_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.ravel()[0]))
    launches = unfused_launches()
    losses = [float(x) for x in warm.float().cpu().ravel()] + losses
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"unfused BERT losses not finite: {losses}")
    if rewritten != [12, 12]:
        raise RuntimeError(f"the pass rewrote {rewritten} attention chains "
                           f"and grad chains, want [12, 12]")
    want = [n * UNFUSED_STEPS
            for n in (B2_PER_STEP, B3_PER_STEP, B4_PER_STEP)]
    if launches != want:
        raise RuntimeError(f"B2/B3/B4 launched {launches} times in "
                           f"{UNFUSED_STEPS} steps, want {want}")
    rewritten_ops = len(passes.apply_passes(
        main, fetch_names=(loss.name,), feed_names=tuple(feed),
        scope=scope).global_block.ops)
    p50 = float(np.median(step_ms))
    log("train_unfused", model="bert-base", batch=TRAIN_BATCH, seq=128,
        dtype="float32", dropout=0.0, steps=UNFUSED_STEPS, step_ms_p50=p50,
        step_ms=step_ms, tokens_per_s=TRAIN_BATCH * 128 / (p50 / 1e3),
        program_ops=len(main.global_block.ops),
        program_ops_after_passes=rewritten_ops, chains_rewritten=rewritten,
        build_s=build_s, warm_run_steps_2_s=warm_s, losses=losses,
        launches_b2_b3_b4=launches,
        launches_per_step=[n / UNFUSED_STEPS for n in launches],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return dict(zip(("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"), launches)), \
        (exe, main, feed, loss, scope)


def phase_train_unfused_oracle():
    """never (the chain as built) / always (B2-B4) / the fused program
    (B1): one startup, three scopes, 3 float32 steps each."""
    unfused, startup, u_loss = build_bert(ORACLE_BATCH, amp=False,
                                          dropout=0.0, lr=ORACLE_LR,
                                          fused=False)
    fused, _startup, f_loss = build_bert(ORACLE_BATCH, amp=False,
                                         dropout=0.0, lr=ORACLE_LR)
    exe = pt.Executor()
    first = pt.framework.Scope()
    exe.run(startup, scope=first)
    feed = bert_feed(ORACLE_BATCH, seed=1, padded_keys=16)
    runs = {}
    try:
        for label, mode, prog, loss, scope in (
                ("never", "never", unfused, u_loss, copy_scope(first)),
                ("always", "always", unfused, u_loss, copy_scope(first)),
                ("fused", "always", fused, f_loss, first)):
            flags.set_flags({"flash_attention": mode})
            fa.reset_launch_counts()
            b1_before = fab.flash_attention_bias.launches
            out = exe.run_steps(prog, feed=feed, fetch_list=[loss],
                                scope=scope, steps=3, return_numpy=True)[0]
            runs[label] = ([float(x) for x in out.ravel()],
                           unfused_launches(),
                           fab.flash_attention_bias.launches - b1_before)
    finally:
        flags.set_flags({"flash_attention": "auto"})
        fa.reset_launch_counts()
    losses = {k: v[0] for k, v in runs.items()}
    gaps = {f"{a}_vs_{b}": max(abs(x - y) / abs(y)
                               for x, y in zip(losses[a], losses[b]))
            for a, b in (("always", "never"), ("fused", "never"),
                         ("always", "fused"))}
    log("train_unfused_oracle", batch=ORACLE_BATCH, dtype="float32", steps=3,
        losses=losses, max_rel_gaps=gaps, tolerance=ORACLE_RTOL,
        launches_b2_b3_b4={k: v[1] for k, v in runs.items()},
        launches_b1={k: v[2] for k, v in runs.items()})
    flat = [x for v in losses.values() for x in v]
    if not all(math.isfinite(x) for x in flat) \
            or max(gaps.values()) > ORACLE_RTOL:
        raise RuntimeError(f"never / always / fused losses {losses}: "
                           f"relative gaps {gaps} > {ORACLE_RTOL}")
    want = {"never": ([0, 0, 0], 0),
            "always": ([3 * B2_PER_STEP, 3 * B3_PER_STEP, 3 * B4_PER_STEP],
                       0),
            "fused": ([0, 0, 0], 3 * B1_PER_STEP)}
    got = {k: (v[1], v[2]) for k, v in runs.items()}
    if got != want:
        raise RuntimeError(f"kernel launches {got}, want {want}")
    if not all(v[2] < v[0] for v in losses.values()):
        raise RuntimeError(f"the loss did not fall: {losses}")


def build_bert_inference():
    """The served model: BERT-base's encoder with a -1 batch dim, dropout 0
    and fused attention, plus the pretraining program's NSP head (pooler
    and 2-way classifier, as ``text/static_models.py`` builds them)."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework.program import Program
    from paddle_tpu_torch.text import static_models as sm

    seq = 128
    main, startup = Program(), Program()
    main.random_seed = 1
    with unique_name.guard(), program_guard(main, startup):
        ids, types, pos = (layers.data(n, [-1, seq], dtype="int64",
                                       append_batch_size=False)
                           for n in INFER_FEEDS[:3])
        mask = layers.data("input_mask", [-1, 1, 1, seq], dtype="float32",
                           append_batch_size=False)
        seq_out = sm.bert_encoder(ids, types, pos, mask, dropout_prob=0.0)
        cls = layers.slice(seq_out, axes=[1], starts=[0], ends=[1])
        cls = layers.reshape(cls, [0, 768])
        pooled = sm._dense(cls, 768, act="tanh", name="pooler")
        nsp_logits = sm._dense(pooled, 2, name="nsp_out")
    return main, startup, seq_out, nsp_logits


INFER_FEEDS = ("input_ids", "token_type_ids", "pos_ids", "input_mask")


def infer_feed(batch, seed):
    """Random token ids, segment ids 0/1, positions, and a key mask that
    pads the last 16 keys of every other sequence."""
    seq = 128
    rng = np.random.RandomState(seed)
    mask = np.zeros((batch, 1, 1, seq), "float32")
    mask[::2, :, :, seq - 16:] = -1e4
    return {"input_ids": rng.randint(0, 30522, (batch, seq)).astype("int64"),
            "token_type_ids": (np.arange(seq)[None] >= seq // 2)
            .repeat(batch, 0).astype("int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "input_mask": mask}


def quant_state(scope):
    """The carriers and scales the weight-quant pass wrote into a scope,
    as host bytes by name."""
    return {n: scope.get_var(n).detach().cpu().view(torch.uint8).numpy()
            if scope.get_var(n).element_size() == 1
            else scope.get_var(n).detach().cpu().numpy()
            for n in scope.local_var_names() if "@WQ" in n}


def phase_infer(model_dir):
    """save_inference_model -> Predictor on the card, three modes."""
    from paddle_tpu_torch import inference

    flags.set_flags({"flash_attention": "always"})
    feeds = {b: infer_feed(b, seed=b) for b in INFER_BATCHES}
    results, outs, launches, preds = {}, {}, {}, {}
    try:
        for mode in INFER_MODES:
            flags.set_flags({"weight_quant": mode})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held_gb = torch.cuda.memory_allocated() / 1e9
            t0 = time.monotonic()
            pred = inference.create_predictor(inference.Config(model_dir))
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            n0 = stat_get("pass_weight_quant_ops")
            t0 = time.monotonic()
            pred.run(feeds[INFER_BATCHES[0]])   # the pass, once per mode
            torch.cuda.synchronize()
            first_s = time.monotonic() - t0
            rewritten = stat_get("pass_weight_quant_ops") - n0
            for b in INFER_BATCHES:             # warm every batch shape
                pred.run(feeds[b])
            torch.cuda.synchronize()
            qo.reset_launch_count()     # the main path's counts start here
            fab.reset_launch_count()
            p50 = {}
            for b in INFER_BATCHES:
                ms = []
                for _ in range(INFER_RUNS):
                    t0 = time.perf_counter()
                    out = pred.run(feeds[b])
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                p50[b] = float(np.median(ms))
                outs[(mode, b)] = out
            runs = INFER_RUNS * len(INFER_BATCHES)
            launches[mode] = (qo.dequant_matmul.launches,
                              fab.flash_attention_bias.launches)
            want = ((B7_PER_RUN if mode else 0) * runs, B1_PER_RUN * runs)
            if launches[mode] != want:
                raise RuntimeError(f"mode {mode!r}: B7/B1 launched "
                                   f"{launches[mode]} times in {runs} runs, "
                                   f"want {want}")
            if rewritten != (B7_PER_RUN if mode else 0):
                raise RuntimeError(f"mode {mode!r}: the pass rewrote "
                                   f"{rewritten} ops, want {B7_PER_RUN}")
            for b in INFER_BATCHES:
                seq, nsp = outs[(mode, b)]
                if seq.shape != (b, 128, 768) or nsp.shape != (b, 2) or \
                        not (np.isfinite(seq).all() and np.isfinite(nsp)
                             .all()):
                    raise RuntimeError(f"mode {mode!r} batch {b}: outputs "
                                       f"{seq.shape} {nsp.shape} not finite"
                                       f" or misshapen")
            results[mode] = dict(
                load_s=load_s, first_run_s=first_s, ops_rewritten=rewritten,
                p50_ms={str(b): p50[b] for b in INFER_BATCHES},
                sequences_per_s_b32=32 / (p50[32] / 1e3),
                launches_b7_b1=list(launches[mode]),
                launches_per_run=[n / runs for n in launches[mode]],
                memory_held_before_gb=held_gb,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
            preds[mode] = pred
    finally:
        flags.set_flags({"weight_quant": "", "flash_attention": "auto"})
    base = outs[("", 32)]
    for mode in INFER_MODES[1:]:
        seq, nsp = outs[(mode, 32)]
        delta = float(np.abs(seq - base[0]).max())
        scale = float(np.abs(base[0]).max())
        results[mode]["seq_max_abs_delta_vs_f32"] = delta
        results[mode]["seq_max_abs_f32"] = scale
        results[mode]["nsp_quality"] = qo.quant_quality_delta(nsp, base[1])
        if mode == "int8" and delta > INT8_QUALITY_BOUND * scale:
            raise RuntimeError(f"int8 sequence output moved {delta} from the"
                               f" float32 run's, beyond "
                               f"{INT8_QUALITY_BOUND} * {scale}")
    log("infer", model="bert-base encoder + nsp head", seq=128,
        dtype="float32", batches=list(INFER_BATCHES), runs=INFER_RUNS,
        int8_bound=INT8_QUALITY_BOUND, **{m or "float32": r
                                          for m, r in results.items()})
    return launches["int8"][0], preds


def phase_infer_oracle(model_dir, card_preds):
    """The same saved model on the CPU (the kernels' plain versions): equal
    carriers and scales, outputs within INFER_ORACLE_TOL, at batch 2."""
    from paddle_tpu_torch import inference

    feed = infer_feed(2, seed=11)
    report = {}
    try:
        for mode in INFER_MODES:
            flags.set_flags({"weight_quant": mode})
            cfg = inference.Config(model_dir)
            cfg.disable_gpu()
            cpu = inference.create_predictor(cfg)
            before = qo.dequant_matmul.launches
            got_cpu = cpu.run(feed)
            got_card = card_preds[mode].run(feed)
            if qo.dequant_matmul.launches - before != (B7_PER_RUN if mode
                                                        else 0):
                raise RuntimeError(f"mode {mode!r}: the CPU predictor "
                                   f"launched B7 or the card's did not")
            ours, theirs = quant_state(card_preds[mode]._scope), \
                quant_state(cpu._scope)
            differ = [n for n in ours
                      if n not in theirs or not np.array_equal(ours[n],
                                                               theirs[n])]
            if sorted(ours) != sorted(theirs) or differ or len(ours) != \
                    (2 * B7_PER_RUN if mode else 0):
                raise RuntimeError(f"mode {mode!r}: the card's carriers and "
                                   f"scales ({len(ours)}) differ from the "
                                   f"CPU's ({len(theirs)}): {differ[:4]}")
            errs = [float(np.abs(a - b).max())
                    for a, b in zip(got_card, got_cpu)]
            report[mode or "float32"] = dict(
                max_abs_err_seq_nsp=errs, carriers_and_scales=len(ours),
                carriers_bit_equal=True)
            if not max(errs) <= INFER_ORACLE_TOL:
                raise RuntimeError(f"mode {mode!r}: card vs CPU outputs "
                                   f"differ by {errs} > {INFER_ORACLE_TOL}")
            del cpu
    finally:
        flags.set_flags({"weight_quant": ""})
    log("infer_oracle", batch=2, tolerance=INFER_ORACLE_TOL, **report)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script measures "
              "the port on the card and has nothing to do here",
              file=sys.stderr)
        return 1
    t_start = time.monotonic()
    name = phase_device()
    phase_build()
    rows = phase_kernels(name)
    launches, model = phase_serve()
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    launches["flash_attention_bias"], state = phase_train()
    phase_train_profile(lambda: exe_run(state))
    del state
    torch.cuda.empty_cache()
    phase_train_oracle()
    unfused, state = phase_train_unfused()
    launches.update(unfused)
    phase_train_profile(
        lambda: exe_run(state), phase="train_unfused_profile",
        kernels=(("b2", "flash_fwd_kernel"),
                 ("b3", "flash_bwd_dq_mma_kernel"),
                 ("b4", "flash_bwd_dkv_mma_kernel")),
        op_types=("flash_attention", "flash_attention_grad"))
    del state
    torch.cuda.empty_cache()
    phase_train_unfused_oracle()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "bert_base")
        t0 = time.monotonic()
        main_prog, startup, seq_out, nsp_logits = build_bert_inference()
        exe = pt.Executor()
        scope = pt.framework.Scope()
        exe.run(startup, scope=scope)
        with pt.fluid.scope_guard(scope):
            pt.fluid.io.save_inference_model(
                model_dir, list(INFER_FEEDS), [seq_out, nsp_logits], exe,
                main_prog)
        log("infer_save", seconds=time.monotonic() - t0,
            files=len(os.listdir(model_dir)),
            bytes=sum(os.path.getsize(os.path.join(model_dir, f))
                      for f in os.listdir(model_dir)))
        del exe, scope
        launches["dequant_matmul"], preds = phase_infer(model_dir)
        pred = preds["int8"]
        feed32 = infer_feed(32, seed=32)
        flags.set_flags({"weight_quant": "int8",
                         "flash_attention": "always"})
        try:
            phase_train_profile(
                lambda: pred.run(feed32), phase="infer_profile",
                kernels=(("b7", "dequant_matmul_"),
                         ("b1", "flash_fwd_kernel")),
                op_types=("dequant_matmul", "fused_multihead_attention"))
            phase_infer_oracle(model_dir, preds)
        finally:
            flags.set_flags({"weight_quant": "", "flash_attention": "auto"})
        del preds, pred
    torch.cuda.empty_cache()
    kernels = []
    main_case = TRAIN_FLASH_CASES[0][0]
    for kernel, case in (("paged_decode_attention", "decode_float32"),
                         ("paged_chunk_attention", "chunk_S1_R1024"),
                         ("flash_attention_bias", FLASH_CASES[0][0]),
                         ("flash_attention_fwd", main_case),
                         ("flash_attention_bwd_dq", main_case),
                         ("flash_attention_bwd_dkv", main_case),
                         ("dequant_matmul", DEQUANT_CASES[0][0])):
        row = next(r for r in rows
                   if r["case"] == case and r["kernel"] == kernel)
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launches[kernel],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "f32_cuda_core_bound_ms": row.get("f32_cuda_core_bound_ms")})
    log("done", seconds=round(time.monotonic() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
