"""KV-cache autoregressive decode engine with continuous batching,
prefix-cache page sharing, chunked prefill, ragged prefill packing,
speculative decoding and KV-page migration -- PyTorch port.

Counterpart of ``paddle_tpu/serving/decode.py``, whose module docstring
describes the design: a fixed slot batch decoding jointly one token per
step, a paged KV cache (``kv_cache.py``) whose pages are reserved at
admission and freed the moment a request ends, prefix sharing with
copy-on-write, chunked prefill, deadline reaping at every step
boundary, streamed tokens, and per-request deterministic sampling.

What the port changes:

- **Captured steps, no executor.**  The page pools live on the
  ``PagedKVCache`` and the steps update them in place
  (``kv_cache.write_*_layer``), where the JAX engine threads them
  through ``Executor.run_persistent`` with donation.  On the card each
  fixed-shape step -- the decode step (``_decode_forward``: every
  layer's LayerNorm, projections, two page writes, B5 and MLP, then the
  head), the draft's proposal burst (``_propose_forward``: k + 1 draft
  decode steps, a greedy argmax feeding the next on the card) and the
  speculative verification (``_verify_forward``: the target's
  ``_rows_forward`` at S slots x R = k + 1 rows through B6) -- runs
  eagerly once, is captured into a CUDA graph (``framework/graphs.py``)
  the second time and replayed after that, fed by the one host-to-device
  copy of ``_upload`` into the graph's static input buffer.  B5's and
  B6's split plans read shapes only, and the pools keep their addresses.
  Sampling runs after the replay (sampled rows draw from host-made
  generators); the per-step sync is the ``.cpu()`` of the tokens (a
  speculative round has two: the proposals, which the verify's write
  coordinates need, and the verified argmaxes).  Prefill (B6, one shape
  per prompt bucket or chunk, and the ragged lanes) runs eagerly.
- **Attention through the hand-written kernels.**  Decode steps call
  ``ops.paged_attention.paged_decode_attention`` (B5); the whole-prompt
  prefill, the prefix-hit suffix, chunked prefill, ragged lanes and
  verification call ``paged_chunk_attention`` (B6) over the page table.
  The JAX whole-prompt prefill attends over a locally built full-width
  K/V with the plain formulation instead; ported literally that would
  materialize ``[t_pad, max_seq, H, D]`` per layer, so the port writes
  the prompt's pages first and reads them back through B6 -- the same
  function on the same bytes.  On CPU tensors both wrappers take their
  plain PyTorch versions.
- **A tolerance instead of bitwise equality.**  The JAX engine's cached
  decode logits are bitwise equal to its full-recompute oracle, a
  property of XLA-CPU reductions.  The port's kernels and matmuls sum
  in other orders at other row counts, so ``recompute_logits`` (plain
  attention over the whole sequence, no pools) agrees with streamed
  decode to a float tolerance, which the tests and ``chip_smoke.py``
  state.  The same holds across paths: speculative verification (B6 at
  R = k + 1) and the decode step (B5) agree only to a tolerance, so the
  port's speculative contract is that every emitted token is the
  target's argmax in the verify logits; greedy speculative output equals
  non-speculative output wherever the top-2 margin of the logits exceeds
  that tolerance.  A migrated request's first token comes from the first
  decode step (B5) over installed pages, a local one's from the
  prefill's last row (B6): again equal up to that tolerance.
- **Sampling** draws each token with its own ``torch.Generator`` seeded
  from (request seed, token index) (``ops/sampling_ops.py``), so a
  request's tokens stay independent of its slot, neighbours and
  replica.
- **Migration** (``submit(extract_kv=True)`` / ``submit(kv_import=)``):
  the payload is a ``kv_cache.KVPageExport`` of torch tensors; on one
  card it moves device to device.

- **MoE** (``moe_experts``): a top-k routed expert FFN in place of the
  dense MLP (``ops/moe_ops.moe_ffn_ref``, dispatch by index), dropless by
  default (capacity = the rows of the call), so every shape of a step is
  static and the decode step stays captured; ``quantize_moe_weights``
  swaps the stacked expert weights for int8 / fp8 carriers with
  per-expert scales, dequantized before the expert products.  Expert
  parallelism (``moe_mesh``, ``shard_moe_weights``) raises, naming ROADMAP
  Queue A item 8: the port runs one card.
"""
from __future__ import annotations

import collections
import math
import queue as _queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..framework.graphs import StepGraph
from ..framework.place import DeviceLike, default_device, device_of
from ..framework.scope import to_tensor
from ..monitor import stat_add, stat_get, stat_max, stat_set
from ..observe import tracer as otrace
from ..observe.histogram import stat_time
from ..ops.moe_ops import _dequant_stacked, moe_ffn_ref
from ..ops.paged_attention import (paged_chunk_attention,
                                   paged_decode_attention)
from ..ops.sampling_ops import greedy_sample, sample_tokens, token_generator
from . import kv_cache
from .batcher import _UNSET, RequestBase
from .buckets import (BucketSpec, DeadlineExceededError, QueueFullError,
                      RequestTooLargeError, ServerClosedError,
                      prefill_bucket_grid, record_pad_waste)
from .kv_cache import CacheConfig, PagedKVCache

_DONE = object()  # stream sentinel
_NEG_INF = -1e30


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} waits for a later slice of the PyTorch port (ROADMAP.md, "
        f"Queue A); the JAX package (paddle_tpu.serving) serves it today")


# ---------------------------------------------------------------------------
# model


def _param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device),
                        requires_grad=False)


# the stacked expert weights a quantized MoE layer holds as carriers
_MOE_QUANT = ("moe_w1", "moe_w2")


class _Layer(nn.Module):
    """One decoder layer's parameters, named as the JAX weights dict's
    per-layer keys: the dense MLP's ``w1``/``w2``, or with ``experts`` the
    router ``gate`` and the stacked ``moe_w1/b1/w2/b2`` (or, once
    quantized, ``moe_w1_q``/``moe_w1_scale`` and ``moe_w2_q``/
    ``moe_w2_scale`` in place of ``moe_w1``/``moe_w2``)."""

    def __init__(self, d_model: int, ffn_dim: int, device,
                 experts: int = 0):
        super().__init__()
        dm, f, e = d_model, ffn_dim, experts
        self.ln1_g = _param(dm, device=device)
        self.ln1_b = _param(dm, device=device)
        self.wq = _param(dm, dm, device=device)
        self.wk = _param(dm, dm, device=device)
        self.wv = _param(dm, dm, device=device)
        self.wo = _param(dm, dm, device=device)
        self.ln2_g = _param(dm, device=device)
        self.ln2_b = _param(dm, device=device)
        self.moe_quantized = False
        if not e:
            self.w1 = _param(dm, f, device=device)
            self.w2 = _param(f, dm, device=device)
            return
        self.gate = _param(dm, e, device=device)
        self.moe_w1 = _param(e, dm, f, device=device)
        self.moe_b1 = _param(e, f, device=device)
        self.moe_w2 = _param(e, f, dm, device=device)
        self.moe_b2 = _param(e, dm, device=device)

    def set_moe_layout(self, entries: Dict) -> None:
        """Register the expert weights in the layout of a weights-dict
        layer ``entries`` (float ``moe_w*`` or quantized ``moe_w*_q`` +
        ``moe_w*_scale``), with its shapes and dtypes, so that
        ``load_state_dict`` takes it."""
        quantized = "moe_w1_q" in entries
        if quantized == self.moe_quantized:
            return
        dev = self.gate.device
        for nm in _MOE_QUANT:
            for key in (nm, nm + "_q", nm + "_scale"):
                if key in self._parameters:
                    del self._parameters[key]
            keys = (nm + "_q", nm + "_scale") if quantized else (nm,)
            for key in keys:
                t = to_tensor(entries[key])
                setattr(self, key, nn.Parameter(torch.zeros(
                    tuple(t.shape), dtype=t.dtype, device=dev),
                    requires_grad=False))
        self.moe_quantized = quantized


class TransformerLM(nn.Module):
    """The decoder-only transformer the engine serves.  Parameter names
    are the keys of the JAX package's weights dict (``tok_emb``,
    ``layers.<i>.wq``, ...), so :func:`weights_from_numpy` carries JAX
    weights across.  Parameters are zero until :meth:`load_weights`
    (which ``DecodeEngine``/``DecodeServer`` call with the weights they
    are given).  The per-row pieces below are shared by every prefill
    and decode path and by the recompute oracle."""

    def __init__(self, vocab_size: int, d_model: int = 64,
                 num_layers: int = 2, num_heads: int = 2,
                 ffn_dim: Optional[int] = None, max_seq_len: int = 256,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 0.0, moe_mesh=None,
                 device: DeviceLike = None):
        super().__init__()
        # MoE FFN (ops/moe_ops.moe_ffn_ref): moe_experts > 0 replaces the
        # dense MLP with a top-k routed expert FFN.  The default capacity
        # factor 0.0 means DROPLESS (cap = E/K * S*K/E = S): with no drops
        # the routed output is row-independent, so cached decode agrees
        # with a prefill recompute to float tolerance.  A finite factor
        # reintroduces batch-dependent drops (fine for training, wrong
        # for the serving oracle).
        self.moe_experts = int(moe_experts)
        self.moe_top_k = int(moe_top_k)
        self.moe_capacity_factor = float(moe_capacity_factor)
        if self.moe_experts and self.moe_top_k > self.moe_experts:
            raise ValueError(f"moe_top_k={moe_top_k} exceeds "
                             f"moe_experts={moe_experts}")
        if moe_mesh is not None:
            from ..distributed.parallel_env import later

            raise later("expert-parallel decode (moe_mesh)")
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        if d_model % num_heads:
            raise ValueError("d_model must divide by num_heads")
        self.head_dim = self.d_model // self.num_heads
        self.ffn_dim = int(ffn_dim) if ffn_dim else 4 * self.d_model
        self.max_seq_len = int(max_seq_len)
        dev = default_device(device)
        dm, v = self.d_model, self.vocab_size
        self.tok_emb = _param(v, dm, device=dev)
        self.pos_emb = _param(self.max_seq_len, dm, device=dev)
        self.lm_head = _param(dm, v, device=dev)
        self.lnf_g = _param(dm, device=dev)
        self.lnf_b = _param(dm, device=dev)
        self.layers = nn.ModuleList(
            [_Layer(dm, self.ffn_dim, dev, self.moe_experts)
             for _ in range(self.num_layers)])

    @property
    def device(self) -> torch.device:
        return device_of(self)

    def init_weights(self, generator: torch.Generator) -> Dict:
        """Random weights in the JAX weights-dict layout, with the JAX
        package's distributions: normal x 1/sqrt(fan_in) for the
        projections, x 0.02 for the embeddings, LayerNorm ones/zeros.
        The stacked expert weights keep the JAX package's scales too:
        ``moe_w1`` [E, Dm, F] x 1/sqrt(E) (its leading dim, as the JAX
        ``dense`` takes it), ``moe_w2`` x 1/sqrt(F), the gate x 0.02,
        biases zero.  Drawn from ``generator`` (on its device) and
        returned on the model's device; not loaded -- pass them to the
        engine."""
        dm, f, v = self.d_model, self.ffn_dim, self.vocab_size

        def dense(shape, scale=None):
            scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
            x = torch.randn(shape, generator=generator,
                            device=generator.device) * scale
            return x.to(self.device, torch.float32)

        def ones():
            return torch.ones(dm, device=self.device)

        def zeros():
            return torch.zeros(dm, device=self.device)

        w = {"tok_emb": dense((v, dm), 0.02),
             "pos_emb": dense((self.max_seq_len, dm), 0.02),
             "lm_head": dense((dm, v)),
             "lnf_g": ones(), "lnf_b": zeros(), "layers": []}
        e = self.moe_experts
        for _ in range(self.num_layers):
            lw = {"ln1_g": ones(), "ln1_b": zeros(),
                  "wq": dense((dm, dm)), "wk": dense((dm, dm)),
                  "wv": dense((dm, dm)), "wo": dense((dm, dm)),
                  "ln2_g": ones(), "ln2_b": zeros()}
            if e:
                lw.update(
                    gate=dense((dm, e), 0.02), moe_w1=dense((e, dm, f)),
                    moe_b1=torch.zeros(e, f, device=self.device),
                    moe_w2=dense((e, f, dm), 1.0 / math.sqrt(f)),
                    moe_b2=torch.zeros(e, dm, device=self.device))
            else:
                lw.update(w1=dense((dm, f)), w2=dense((f, dm)))
            w["layers"].append(lw)
        return w

    def load_weights(self, weights: Dict) -> "TransformerLM":
        """Copy a weights dict in the JAX layout (top-level tensors plus
        ``"layers"``: one dict per layer; tensors or numpy arrays) into
        the parameters.  Missing, extra or misshapen entries raise."""
        flat = {}
        for key, val in weights.items():
            if key != "layers":
                flat[key] = val
                continue
            if len(val) != self.num_layers:
                raise ValueError(f"weights hold {len(val)} layers, the "
                                 f"model has {self.num_layers}")
            for i, lw in enumerate(val):
                if self.moe_experts:
                    self.layers[i].set_moe_layout(lw)
                for name, t in lw.items():
                    flat[f"layers.{i}.{name}"] = t
        with torch.no_grad():
            self.load_state_dict(
                {k: t if isinstance(t, torch.Tensor) else to_tensor(t)
                 for k, t in flat.items()},
                strict=True)
        return self

    # -- per-row pieces (shared by prefill, decode and the oracle) --------
    @staticmethod
    def _ln(x, g, b):
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * g + b

    def _embed(self, tokens, positions):
        return self.tok_emb[tokens.long()] + self.pos_emb[positions.long()]

    def _qkv(self, lw: _Layer, h):
        n, d = self.num_heads, self.head_dim
        q = (h @ lw.wq).reshape(*h.shape[:-1], n, d)
        k = (h @ lw.wk).reshape(*h.shape[:-1], n, d)
        v = (h @ lw.wv).reshape(*h.shape[:-1], n, d)
        return q, k, v

    def _attn_out(self, lw: _Layer, ctx):
        return ctx.reshape(*ctx.shape[:-2], self.d_model) @ lw.wo

    def _mlp(self, lw: _Layer, h):
        if self.moe_experts:
            return self._moe_mlp(lw, h)
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(h @ lw.w1, approximate="tanh") @ lw.w2

    def _moe_mlp(self, lw: _Layer, h):
        """Routed expert FFN, dropless by default (see __init__).
        Quantized expert carriers (``quantize_moe_weights``) dequantize
        per expert before the expert products."""
        if lw.moe_quantized:
            w1 = _dequant_stacked(lw.moe_w1_q, lw.moe_w1_scale)
            w2 = _dequant_stacked(lw.moe_w2_q, lw.moe_w2_scale)
        else:
            w1, w2 = lw.moe_w1, lw.moe_w2
        cf = self.moe_capacity_factor or (
            self.moe_experts / self.moe_top_k)
        out, _aux, _load, _chunked = moe_ffn_ref(
            h, lw.gate, w1, lw.moe_b1, w2, lw.moe_b2,
            num_experts=self.moe_experts, top_k=self.moe_top_k,
            capacity_factor=cf)
        return out.to(h.dtype)

    def _head(self, x):
        return self._ln(x, self.lnf_g, self.lnf_b) @ self.lm_head


def quantize_moe_weights(weights: Dict, mode: str = "int8") -> Dict:
    """Post-training quantization of a TransformerLM weights dict's
    stacked expert tensors -- the serving twin of the
    PostTrainingWeightQuantPass moe_ffn branch (slim/quantization.py):
    every layer's ``moe_w1``/``moe_w2`` becomes an int8 (or fp8) carrier
    ``moe_w*_q`` plus a per-expert ``[E, out]`` scale ``moe_w*_scale``
    (ops/quant_ops.quantize_weight_stacked), which ``_moe_mlp``
    dequantizes before the expert products.  Gate, biases and everything
    dense stay full precision.  Returns a NEW dict; the original is
    untouched (it stays the full-precision oracle)."""
    from ..ops.quant_ops import quantize_weight_stacked

    out = dict(weights)
    layers = []
    n_quantized = 0
    for lw in weights["layers"]:
        lw = dict(lw)
        if "moe_w1" in lw:
            for nm in _MOE_QUANT:
                q, s = quantize_weight_stacked(lw.pop(nm), 2, mode)
                lw[nm + "_q"] = q
                lw[nm + "_scale"] = s
                n_quantized += 1
        layers.append(lw)
    if not n_quantized:
        raise ValueError(
            "quantize_moe_weights found no stacked expert weights; "
            "build the model with moe_experts > 0")
    out["layers"] = layers
    stat_add("serving_moe_weights_quantized", n_quantized)
    return out


def shard_moe_weights(weights, mesh):
    """Expert-parallel placement of the stacked expert weights over a
    mesh's 'ep' axis: the port runs one card, so this raises, naming
    ROADMAP Queue A item 8."""
    from ..distributed.parallel_env import later

    raise later("shard_moe_weights (expert-parallel serving)")


def weights_from_numpy(np_weights: Dict, device: DeviceLike = None) -> Dict:
    """The JAX package's weights dict as numpy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, model.init_weights(key))``; the
    int8 / float8 carriers of ``quantize_moe_weights`` included) -> the
    same layout of torch tensors on ``device`` (CUDA by default)."""
    dev = default_device(device)

    def conv(a):
        return to_tensor(np.asarray(a)).to(dev, copy=True)

    out = {k: conv(v) for k, v in np_weights.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lw.items()}
                     for lw in np_weights["layers"]]
    return out


# ---------------------------------------------------------------------------
# requests


class DecodeRequest(RequestBase):
    """Streaming future for one generation request.

    Tokens arrive on an internal stream as the engine produces them:
    iterate ``tokens()`` for a generator, pass ``on_token=`` for a
    callback (called from the engine thread — keep it cheap), or call
    ``result()`` for the completed id list.  ``generated`` always
    holds the ids produced so far (partial output survives a deadline
    reap).  With ``record_logits`` each token's logits (float32 numpy)
    land on ``logits_trace``.

    Disaggregated serving (serving/disagg.py): an ``extract_kv`` request
    is the internal prefill leg -- on success its slot's prompt pages are
    gathered into ``kv_export`` (a ``kv_cache.KVPageExport``) before the
    slot releases, and it stays out of the client-facing SLO plane (the
    logical request's first token is the decode replica's).
    ``kv_import`` carries such a payload into an engine: admission
    installs the pages and starts at the first decode step."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "top_k",
                 "top_p", "seed", "on_token", "generated", "_stream",
                 "t_first_token", "t_last_token", "record_logits",
                 "logits_trace", "speculative", "finish_reason",
                 "extract_kv", "kv_import", "kv_export")

    _deadline_stat = "decode_deadline_exceeded"
    _outcome_prefix = "decode"

    def __init__(self, prompt, max_new_tokens, deadline, temperature,
                 top_k, top_p, seed, on_token, record_logits=False,
                 speculative=None, extract_kv=False, kv_import=None):
        super().__init__(deadline)
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.on_token = on_token
        self.generated: List[int] = []
        self._stream: _queue.Queue = _queue.Queue()
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.record_logits = bool(record_logits)
        self.logits_trace: List[np.ndarray] = []
        self.speculative = speculative  # None=auto, False=opt out
        self.finish_reason: Optional[str] = None
        self.extract_kv = bool(extract_kv)
        self.kv_import = kv_import
        self.kv_export = None

    # terminal accounting (RequestBase._on_terminal hooks) ---------------
    def _finish_stats(self, outcome, latency):
        stat_time("decode_request_latency_seconds", latency)

    def _summary(self, outcome, latency):
        n = len(self.generated)
        ttft = None if self.t_first_token is None \
            else self.t_first_token - self.t_enqueue
        tpot = None
        if n >= 2 and self.t_last_token is not None \
                and self.t_first_token is not None:
            # per-request MEAN time-per-output-token (what the tpot_p50
            # SLO objective judges)
            tpot = (self.t_last_token - self.t_first_token) / (n - 1)
        return {
            "outcome": outcome,
            "latency_s": round(latency, 6),
            "ttft_s": None if ttft is None else round(ttft, 6),
            "tpot_s": None if tpot is None else round(tpot, 6),
            "n_tokens": n,
            "prompt_len": len(self.prompt),
            "reason": self.finish_reason,
        }

    def _slo_check(self, summary):
        if self.extract_kv:
            # internal disagg prefill leg: the logical request is observed
            # once, by its decode-side request
            return ()
        from ..observe import slo as _slo

        return _slo.observe_request(summary)

    # engine side ---------------------------------------------------------
    def _emit(self, token: int) -> None:
        now = time.monotonic()
        if self.t_first_token is None:
            self.t_first_token = now
            if not self.extract_kv:
                stat_time("ttft_seconds",
                          self.t_first_token - self.t_enqueue)
        self.t_last_token = now
        self.generated.append(int(token))
        self._stream.put(int(token))
        if self.on_token is not None:
            try:
                self.on_token(int(token))
            except Exception:  # noqa: BLE001 — user callback, isolate
                stat_add("decode_callback_errors")

    def _finish(self, error=None) -> bool:
        won = self._complete(result=list(self.generated), error=error)
        self._stream.put(_DONE)  # always: a racing client-side reap
        # must still terminate a tokens() reader
        return won

    # client side ---------------------------------------------------------
    def tokens(self, timeout: Optional[float] = None):
        """Generator over streamed token ids; raises the request's
        error (after yielding everything produced) if it failed."""
        while True:
            budget = timeout
            if self.deadline is not None:
                # the engine reaps at the next step boundary; the small
                # grace covers its in-flight step
                rem = max(self.deadline - time.monotonic(), 0.0) + 1.0
                budget = rem if budget is None else min(budget, rem)
            try:
                item = self._stream.get(timeout=budget)
            except _queue.Empty:
                raise TimeoutError(
                    "no token within the wait budget") from None
            if item is _DONE:
                break
            yield item
        if self._error is not None:
            raise self._error


class _SlotState:
    __slots__ = ("req", "n_generated", "last_token", "t_last", "phase",
                 "prefill_pos", "write_trash_once", "spec", "draft_lag",
                 "chunks", "t_admit")

    def __init__(self, req):
        self.req = req
        self.n_generated = 0
        self.last_token = 0
        self.t_last = time.monotonic()
        self.t_admit = self.t_last
        self.chunks = 0             # prefill chunks dispatched
        self.phase = "prefill"      # "prefill" -> "decode"
        self.prefill_pos = 0        # next prompt position to prefill
        self.write_trash_once = False  # cache-hit path: first decode
        # write re-derives a position the shared pages already hold
        self.spec = False           # speculative-decode eligible
        self.draft_lag = 0          # trailing positions written by the
        # normal step (target-only) on a spec slot -- the draft pool is
        # stale there, so registration excludes them


# ---------------------------------------------------------------------------
# engine


class DecodeConfig:
    """Engine knobs; defaults come from the ``FLAGS_decode_*`` flags.
    ``ragged_prefill_rows`` (with ``prefill_chunk_pages`` > 0) packs that
    many one-row lanes per prefill dispatch; ``spec_k`` (with a draft
    model) is the speculative window."""

    def __init__(self, slots: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 max_queue: int = 256,
                 default_deadline_ms: Optional[float] = None,
                 cache_dtype="float32",
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk_pages: Optional[int] = None,
                 ragged_prefill_rows: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 kv_quant: Optional[bool] = None):
        from ..framework import flags

        self.slots = int(slots if slots is not None
                         else flags.flag("decode_slots"))
        self.max_seq_len = int(max_seq_len if max_seq_len is not None
                               else flags.flag("decode_max_seq_len"))
        self.page_size = int(page_size if page_size is not None
                             else flags.flag("decode_page_size"))
        self.num_pages = num_pages
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else flags.flag("decode_max_new_tokens"))
        self.eos_id = eos_id
        self.max_queue = int(max_queue)
        self.default_deadline_ms = default_deadline_ms
        self.cache_dtype = cache_dtype
        self.prefix_cache = bool(
            prefix_cache if prefix_cache is not None
            else flags.flag("decode_prefix_cache"))
        self.prefill_chunk_pages = int(
            prefill_chunk_pages if prefill_chunk_pages is not None
            else flags.flag("decode_prefill_chunk_pages"))
        self.ragged_prefill_rows = int(
            ragged_prefill_rows if ragged_prefill_rows is not None
            else flags.flag("decode_ragged_prefill"))
        self.spec_k = int(spec_k if spec_k is not None
                          else flags.flag("decode_spec_k"))
        self.kv_quant = bool(kv_quant if kv_quant is not None
                             else flags.flag("decode_kv_quant"))


class DecodeEngine:
    """One decode replica: a slot batch, its paged KV cache, and the
    consumer thread that runs admission -> prefill -> joint decode
    step, forever.  ``continuous=False`` degrades admission to the
    one-shot group mode (a new group only starts when EVERY slot is
    free).  Runs on the model's device; ``weights`` (the JAX layout, see
    ``TransformerLM.load_weights``) are loaded into the model unless
    None, which serves the parameters the model already holds.

    ``draft_model``/``draft_weights`` arm speculative decoding (with
    ``spec_k > 0``): the draft's page pools are indexed by the SAME page
    ids as the target's, so prefix sharing, reservation accounting and
    copy-on-write cover both."""

    def __init__(self, model: TransformerLM, weights: Optional[Dict] = None,
                 config: Optional[DecodeConfig] = None,
                 name: str = "replica-0", continuous: bool = True,
                 draft_model: Optional[TransformerLM] = None,
                 draft_weights: Optional[Dict] = None):
        self.model = model
        self.config = config or DecodeConfig()
        self.name = name
        self._continuous = bool(continuous)
        c = self.config
        if c.max_seq_len > model.max_seq_len:
            raise ValueError(
                f"DecodeConfig.max_seq_len {c.max_seq_len} exceeds the "
                f"model's positional table ({model.max_seq_len})")
        self._draft_model = draft_model
        if draft_model is not None:
            if draft_weights is None:
                raise ValueError(
                    "draft_model needs draft_weights for speculative "
                    "decoding")
            if int(draft_model.vocab_size) != int(model.vocab_size):
                raise ValueError(
                    f"speculative draft/target vocab mismatch: draft "
                    f"{draft_model.vocab_size} vs target "
                    f"{model.vocab_size} -- the draft's proposals would "
                    f"index a different token space; re-export the "
                    f"draft with the target's vocabulary")
            if int(draft_model.max_seq_len) < c.max_seq_len:
                raise ValueError(
                    f"draft positional table ({draft_model.max_seq_len})"
                    f" is shorter than max_seq_len ({c.max_seq_len})")
            if draft_model.device != model.device:
                raise ValueError(
                    f"draft model on {draft_model.device}, target on "
                    f"{model.device}: both must share the device")
        if weights is not None:
            model.load_weights(weights)
        if draft_model is not None:
            draft_model.load_weights(draft_weights)
        self.device = model.device
        self._cache = PagedKVCache(
            CacheConfig(model.num_layers, model.num_heads, model.head_dim,
                        c.slots, c.max_seq_len, c.page_size,
                        num_pages=c.num_pages, dtype=c.cache_dtype,
                        quantized=c.kv_quant),
            self.device, prefix_cache=c.prefix_cache)
        if draft_model is not None:
            # freed-page scale resets, copy-on-write and the audit cover
            # the draft pools too (same page ids)
            self._cache.add_draft_pools(draft_model.num_layers,
                                        draft_model.num_heads,
                                        draft_model.head_dim)
        # per-request timeline hook: claim/CoW/register/evict events
        # from the cache land on the owning request's trace
        self._cache.on_event = self._on_cache_event
        self._admitting = None  # request whose claim() is in flight
        self._buckets = BucketSpec(
            (1,), prefill_bucket_grid(c.max_seq_len, c.page_size))
        self._slots: List[Optional[_SlotState]] = [None] * c.slots
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._closing = False
        self._abort = False
        self._thread = None
        self._seq = 0  # default-seed counter
        self._prefill_rr = 0  # chunked-prefill round-robin cursor
        self.tokens_total = 0
        # per-replica accounting (stats()/DecodeServer /stats)
        self._hit_pages = 0
        self._prompt_pages = 0
        self._cow_copies = 0
        self._prefill_chunk_count = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        # the captured fixed-shape steps (framework/graphs.py) by name --
        # "decode", "propose", "verify" -- and their static input buffers
        self._graphs: Dict[str, StepGraph] = {}
        self._graph_inputs: Dict[str, torch.Tensor] = {}
        self._captures = self.device.type == "cuda"

    @property
    def spec_enabled(self) -> bool:
        return self._draft_model is not None and self.config.spec_k > 0

    @property
    def _step(self) -> Optional[StepGraph]:
        """The decode step's graph (None before the first step on the
        card)."""
        return self._graphs.get("decode")

    # -- per-request tracing helpers -------------------------------------
    @staticmethod
    def _tev(req, name, **attrs) -> None:
        tr = req.trace
        if tr is not None:
            tr.event(name, **attrs)

    def _on_cache_event(self, slot, name, **attrs):
        """PagedKVCache event hook: attribute cache lifecycle events
        (claim / cow_swap / evict / register) to the owning request's
        timeline.  During admission the slot state does not exist yet,
        so the claim-in-flight request is the fallback owner (evictions
        triggered by its allocation ARE its wait)."""
        st = self._slots[slot] if slot is not None \
            and 0 <= slot < len(self._slots) else None
        req = st.req if st is not None else self._admitting
        if req is not None:
            self._tev(req, f"cache/{name}",
                      **({"slot": slot} if slot is not None else {}),
                      **attrs)

    # -- device work: the model over the page pools ----------------------
    def _upload(self, *arrays, into: Optional[torch.Tensor] = None):
        """Host int arrays -> int32 device tensors of the same shapes, in
        ONE host-to-device copy (views into one contiguous buffer:
        ``into`` when given, else a new one)."""
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int32).ravel() for a in arrays]))
        buf = flat.to(self.device) if into is None else into.copy_(flat)
        out, o = [], 0
        for a in arrays:
            n = int(np.prod(np.shape(a)))
            out.append(buf[o:o + n].view(*np.shape(a)))
            o += n
        return out

    @staticmethod
    def _token_writer(pools, write_page, write_off):
        """Per-layer writer of one position per row: the rows' K/V
        (``[..., H, D]``, flattened) at ``(write_page, write_off)``."""
        def write(l, k, v):
            kv_cache.write_token_layer(pools.k_pages, pools.k_scales, l,
                                       k.reshape(-1, *k.shape[-2:]),
                                       write_page, write_off)
            kv_cache.write_token_layer(pools.v_pages, pools.v_scales, l,
                                       v.reshape(-1, *v.shape[-2:]),
                                       write_page, write_off)
        return write

    @staticmethod
    def _prompt_writer(pools, page_ids):
        """Per-layer writer of one slot's padded prompt, page-wholesale
        into ``page_ids``."""
        def write(l, k, v):
            kv_cache.write_prompt_layer(pools.k_pages, pools.k_scales, l,
                                        k[0], page_ids)
            kv_cache.write_prompt_layer(pools.v_pages, pools.v_scales, l,
                                        v[0], page_ids)
        return write

    def _decode_forward(self, model, pools, tokens, positions, page_table,
                        write_page, write_off):
        """One single-token step of ``model`` over ``pools`` (the target's
        or the draft's): embed -> per layer (write K/V at (write_page,
        write_off) in place, attend over each slot's live history with
        B5) -> logits [S, V].  Shared by the target's decode step and the
        draft's proposal burst."""
        x = model._embed(tokens, positions)               # [S, Dm]
        lengths = positions + 1  # the token written THIS step included
        write = self._token_writer(pools, write_page, write_off)
        for l, lw in enumerate(model.layers):
            h = model._ln(x, lw.ln1_g, lw.ln1_b)
            q, k, v = model._qkv(lw, h)                   # [S, H, D]
            write(l, k, v)
            ks, vs = pools.scales(l)
            ctx = paged_decode_attention(q, pools.k_pages[l],
                                         pools.v_pages[l], page_table,
                                         lengths, k_scales=ks, v_scales=vs)
            x = x + model._attn_out(lw, ctx)
            x = x + model._mlp(lw, model._ln(x, lw.ln2_g, lw.ln2_b))
        return model._head(x)                             # [S, V]

    def _rows_forward(self, model, pools, tokens, positions, page_table,
                      write):
        """R query rows per slot (``tokens``/``positions`` [S, R]) of
        ``model`` over ``pools``: per layer ``write(layer, k, v)`` stores
        the rows' K/V in place, then B6 attends each row over its slot's
        page table with the row's causal length.  Serves the whole-prompt
        prefill, the prefix-hit suffix, chunked prefill, ragged lanes
        (S = lanes, R = 1) and verification (S = slots, R = k + 1).
        Returns the last hidden states [S, R, Dm]; the caller runs the
        head on the rows it needs."""
        # clip keeps padded rows inside the positional table; live rows
        # are in range by the reservation accounting
        x = model._embed(tokens, positions.clamp(0, model.max_seq_len - 1))
        row_lengths = positions + 1
        for l, lw in enumerate(model.layers):
            h = model._ln(x, lw.ln1_g, lw.ln1_b)
            q, k, v = model._qkv(lw, h)                   # [S, R, H, D]
            write(l, k, v)
            ks, vs = pools.scales(l)
            ctx = paged_chunk_attention(q, pools.k_pages[l],
                                        pools.v_pages[l], page_table,
                                        row_lengths, k_scales=ks,
                                        v_scales=vs)
            x = x + model._attn_out(lw, ctx)
            x = x + model._mlp(lw, model._ln(x, lw.ln2_g, lw.ln2_b))
        return x

    def _propose_forward(self, tok0, start, live, trash_first, page_table):
        """The draft's proposal burst: k + 1 single-token draft steps over
        the draft pools (the + 1 keeps the draft's cache synced through
        the bonus position when every proposal is accepted), each step's
        greedy argmax the next step's token, on the card.  Write coords
        come from the page table; dead slots, positions past the slot
        capacity and the trash-first position aim at page 0.  Returns the
        proposals [S, k + 1]."""
        model, pools = self._draft_model, self._cache.draft
        cc = self._cache.config
        p = cc.page_size
        live = live != 0
        cur, props = tok0, []
        for j in range(self.config.spec_k + 1):
            pos = start + j                                  # [S]
            idx = (pos // p).clamp(0, cc.pages_per_slot - 1)
            pid = torch.gather(page_table, 1, idx[:, None].long())[:, 0]
            pid = torch.where(live & (pos < cc.max_seq_len), pid, 0)
            if j == 0:
                pid = torch.where(trash_first != 0, 0, pid)
            logits = self._decode_forward(
                model, pools, cur, pos.clamp(0, model.max_seq_len - 1),
                page_table, pid, pos % p)
            cur = greedy_sample(logits)                      # [S]
            props.append(cur)
        return torch.stack(props, dim=1)

    def _verify_forward(self, tokens, start, page_table, write_page,
                        write_off):
        """Speculative verification: the target over R = k + 1 rows a
        slot (the last token and the k proposals) at positions ``start +
        r``, rows written at ``(write_page, write_off)`` (page 0 for rows
        that must not land), through B6.  Returns the target's argmax and
        logits [S, R(, V)]."""
        r = tokens.shape[1]
        positions = start[:, None] + torch.arange(
            r, dtype=torch.int32, device=tokens.device)[None]
        x = self._rows_forward(
            self.model, self._cache.target, tokens, positions, page_table,
            self._token_writer(self._cache.target, write_page.reshape(-1),
                               write_off.reshape(-1)))
        logits = self.model._head(x)                          # [S, R, V]
        return greedy_sample(logits), logits

    def _graph_step(self, key: str, fn, *arrays):
        """``fn``'s outputs from its host int inputs (``arrays``, before
        ``_upload``).  On the card, per ``key``: the first run eager on
        the step's side stream, the second captured, then replays into
        the same output buffers, which the caller reads before the next
        run."""
        if not self._captures:
            return fn(*self._upload(*arrays))
        step = self._graphs.get(key)
        if step is None:
            step = self._graphs[key] = StepGraph(self.device)
            return step.on_side_stream(lambda: fn(*self._upload(*arrays)))
        if step.graph is None:
            buf = self._graph_inputs[key] = torch.empty(
                sum(np.size(a) for a in arrays), dtype=torch.int32,
                device=self.device)
            inputs = self._upload(*arrays, into=buf)
            step.capture(lambda: fn(*inputs))
        else:
            self._upload(*arrays, into=self._graph_inputs[key])
        step.replay()
        return step.outputs

    def _decode_step(self, *arrays):
        """The target's decode step's logits [S, V] from its host inputs
        (``_decode_forward``'s after the model and pools)."""
        return self._graph_step(
            "decode", lambda *t: self._decode_forward(
                self.model, self._cache.target, *t), *arrays)

    def _sample_one(self, req, logits, index: int) -> int:
        """Sample one token for ``req`` from its logits [V]."""
        gen = token_generator(req.seed, index, self.device) \
            if req.temperature > 0.0 else None
        tok = sample_tokens([gen], logits[None], [req.temperature],
                            [req.top_k], [req.top_p])
        return int(tok.cpu()[0])

    # -- client side ------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens=None,
               deadline_ms=_UNSET, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               seed: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               record_logits: bool = False,
               speculative: Optional[bool] = None,
               extract_kv: bool = False,
               kv_import=None) -> DecodeRequest:
        from ..observe.request_trace import get_trace_store

        prompt = [int(t) for t in prompt]
        trace = get_trace_store().start(
            "decode", replica=self.name, prompt_len=len(prompt),
            max_new_tokens=None if max_new_tokens is None
            else int(max_new_tokens))
        try:
            return self._submit_traced(
                trace, prompt, max_new_tokens, deadline_ms, temperature,
                top_k, top_p, seed, on_token, record_logits, speculative,
                extract_kv, kv_import)
        except Exception as e:
            # submit-time rejection IS a terminal outcome: count it,
            # record its (instant) terminal latency, and tail-retain the
            # trace.  Only SERVER-fault rejections burn the SLO budget.
            outcome = "cancelled" if isinstance(e, ServerClosedError) \
                else "rejected"
            stat_add(f"decode_requests_total_{outcome}")
            latency = time.monotonic() - trace.t_start
            stat_time("decode_request_latency_seconds", latency)
            summary = {"outcome": outcome,
                       "latency_s": round(latency, 6),
                       "ttft_s": None, "tpot_s": None, "n_tokens": 0,
                       "prompt_len": len(prompt)}
            violations = ()
            if isinstance(e, (QueueFullError, ServerClosedError)):
                try:
                    from ..observe import slo as _slo

                    violations = _slo.observe_request(summary)
                except Exception:  # noqa: BLE001 — never mask the
                    stat_add("request_trace_errors")  # rejection
            summary.pop("outcome")  # stored top-level on the trace
            get_trace_store().finish(
                trace, outcome=outcome,
                reason=f"{type(e).__name__}: {e}",
                violations=violations, **summary)
            raise

    def _submit_traced(self, trace, prompt, max_new_tokens, deadline_ms,
                       temperature, top_k, top_p, seed, on_token,
                       record_logits, speculative, extract_kv,
                       kv_import) -> DecodeRequest:
        c = self.config
        if not prompt:
            raise ValueError("prompt must hold at least one token id")
        if kv_import is not None:
            # migrated admission (serving/disagg.py): validate the payload
            # against THIS engine's pool geometry at submit time -- a
            # mismatch must reject loudly, never corrupt pools
            cc = self._cache.config
            if extract_kv:
                raise ValueError(
                    "kv_import and extract_kv are mutually exclusive (a "
                    "request is either the prefill leg or the decode leg "
                    "of a disagg handoff, not both)")
            if speculative:
                raise ValueError(
                    "kv_import cannot be speculative: the migration "
                    "payload carries the target pools only -- the draft "
                    "pools never saw the prompt K/V")
            if bool(kv_import.quantized) != bool(cc.quantized):
                raise ValueError(
                    f"kv_import quantized={kv_import.quantized} but this "
                    f"engine's cache quantized={cc.quantized} -- prefill "
                    f"and decode replicas must agree on "
                    f"FLAGS_decode_kv_quant")
            if int(kv_import.page_size) != cc.page_size:
                raise ValueError(
                    f"kv_import page_size {kv_import.page_size} != "
                    f"engine page_size {cc.page_size}")
            if int(kv_import.n_tokens) != len(prompt):
                raise ValueError(
                    f"kv_import covers {kv_import.n_tokens} tokens but "
                    f"the prompt has {len(prompt)}")
            if int(kv_import.n_pages) != cc.pages_for(len(prompt)):
                raise ValueError(
                    f"kv_import carries {kv_import.n_pages} pages but "
                    f"the prompt needs {cc.pages_for(len(prompt))}")
        if speculative:
            # a request that ASKS for speculative decoding must get it or
            # fail, never silently degrade
            if self._draft_model is None:
                raise ValueError(
                    "speculative=True but the engine has no draft model "
                    "(DecodeEngine(draft_model=, draft_weights=))")
            if c.spec_k <= 0:
                raise ValueError(
                    "speculative=True but FLAGS_decode_spec_k / "
                    "DecodeConfig.spec_k is 0")
            if float(temperature) > 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only (every emitted "
                    "token is the target's argmax); submit with "
                    "temperature=0")
        if max_new_tokens is None:
            max_new_tokens = c.max_new_tokens
        if len(prompt) + int(max_new_tokens) > c.max_seq_len:
            raise RequestTooLargeError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slot capacity "
                f"({c.max_seq_len}); raise FLAGS_decode_max_seq_len or "
                f"shorten the request")
        cc = self._cache.config
        need = cc.pages_for(len(prompt) + int(max_new_tokens))
        if need > cc.num_pages - 1:  # page 0 is trash, never allocatable
            # an unsatisfiable reservation must be rejected HERE: queued
            # it would head-of-line-block the engine forever
            raise RequestTooLargeError(
                f"request needs {need} cache pages but the pool only "
                f"has {cc.num_pages - 1}; raise num_pages or shorten "
                f"the request")
        self._buckets.seq_bucket(len(prompt))  # raises RequestTooLarge
        if deadline_ms is _UNSET:
            deadline_ms = c.default_deadline_ms
        deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1e3
        with self._cond:
            if self._closing:
                raise ServerClosedError("decode engine is stopping")
            if len(self._queue) >= c.max_queue:
                stat_add("decode_rejected_queue_full")
                raise QueueFullError(
                    f"decode queue is at capacity ({c.max_queue})")
            if seed is None:
                seed = self._seq
            self._seq += 1
            req = DecodeRequest(prompt, max_new_tokens, deadline,
                                temperature, top_k, top_p, seed,
                                on_token, record_logits=record_logits,
                                speculative=speculative,
                                extract_kv=extract_kv,
                                kv_import=kv_import)
            req.trace = trace
            self._queue.append(req)
            trace.event("enqueue", queue_depth=len(self._queue),
                        max_new_tokens=int(max_new_tokens),
                        seed=int(seed),
                        deadline_ms=None if deadline_ms is None
                        else float(deadline_ms))
            stat_add("decode_requests")
            stat_set("decode_queue_depth", len(self._queue))
            self._cond.notify_all()
        return req

    def generate(self, prompt, **kw) -> List[int]:
        return self.submit(prompt, **kw).result()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "DecodeEngine":
        with self._cond:
            if self._thread is not None:
                return self
            self._closing = self._abort = False
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"decode-{self.name}")
            self._thread.start()
        from ..observe import flight as _flight

        _flight.record("serving/decode_start", name=self.name,
                       device=str(self.device),
                       slots=self.config.slots,
                       max_seq_len=self.config.max_seq_len,
                       page_size=self.config.page_size,
                       prefix_cache=self.config.prefix_cache,
                       kv_quant=self.config.kv_quant,
                       spec_k=self.config.spec_k
                       if self.spec_enabled else 0)
        stat_set("decode_kv_quant_enabled",
                 1 if self.config.kv_quant else 0)
        stat_set("decode_kv_page_bytes", self._cache.config.page_bytes())
        return self

    def stop(self, drain: bool = True):
        with self._cond:
            self._closing = True
            if not drain:
                self._abort = True
                while self._queue:
                    req = self._queue.popleft()
                    if req._finish(error=ServerClosedError(
                            "engine stopped before the request ran")):
                        stat_add("decode_cancelled")
                stat_set("decode_queue_depth", 0)
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        from ..observe import flight as _flight

        _flight.record("serving/decode_stop", name=self.name,
                       drain=bool(drain))

    def __enter__(self) -> "DecodeEngine":
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc[0] is None)
        return False

    # -- scheduler --------------------------------------------------------
    @property
    def live_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def free_slots(self) -> int:
        return self.config.slots - self.live_slots

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def _expire(self, req, where: str) -> None:
        if req._finish(error=DeadlineExceededError(
                f"deadline exceeded {where}")):
            stat_add("decode_deadline_exceeded")

    def _reap_queue_locked(self):
        now = time.monotonic()
        live = []
        for r in self._queue:
            if r.done():
                continue
            if r.expired(now):
                self._expire(r, "while queued")
                continue
            live.append(r)
        if len(live) != len(self._queue):
            self._queue = collections.deque(live)
            stat_set("decode_queue_depth", len(self._queue))

    def _admit_locked(self):
        if not self._continuous and self.live_slots:
            return []  # one-shot baseline: groups never mix
        admitted = []
        while self._queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                break
            req = self._queue[0]
            if req.done():
                self._queue.popleft()
                continue
            if req.expired():
                self._queue.popleft()
                self._expire(req, "while queued")
                continue
            # shared-aware worst-case reservation: pages for prompt +
            # max_new minus every prefix-cache hit, with a CoW spare
            # held back for a borrowed partial page
            slot = free[0]
            need = len(req.prompt) + req.max_new_tokens
            self._admitting = req
            try:
                # a migrated admission claims ALL-FRESH pages (no prefix
                # lookup): the installed pages must be solely owned
                info = self._cache.claim(
                    slot, need,
                    prompt=None if req.kv_import is not None
                    else req.prompt)
            finally:
                self._admitting = None
            if info is None:
                stat_add("decode_admission_blocked_pages")
                self._tev(req, "admission_blocked",
                          reason="pages",
                          free_pages=self._cache.allocator.num_free)
                break  # FIFO head-of-line: wait for pages to free
            self._queue.popleft()
            st = _SlotState(req)
            st.spec = (self.spec_enabled and req.temperature <= 0.0
                       and req.speculative is not False
                       and req.kv_import is None)
            if req.kv_import is not None:
                self._account_migrated(slot, st, req)
            else:
                self._account_claim(slot, st, info)
            self._slots[slot] = st
            admitted.append((slot, req))
        stat_set("decode_queue_depth", len(self._queue))
        return admitted

    def _account_migrated(self, slot: int, st: _SlotState, req) -> None:
        """Admit a request whose prompt K/V arrives as a migration payload
        (disaggregated serving): install the pages into the slot's fresh
        claim, then start the slot like a full-prefix-cache hit -- the
        pages hold prompt positions ``0..n-1``, so the first decode step
        re-derives the last prompt position's logits (its own K/V write
        aims at trash) and samples the first token with token index 0,
        the generator a local prefill's first token draws from."""
        n = len(req.prompt)
        self._cache.install_pages(slot, req.kv_import)
        st.phase = "decode"
        st.write_trash_once = True
        st.last_token = req.prompt[-1]
        st.prefill_pos = n
        self._cache.lengths[slot] = n - 1
        stat_add("decode_migrated_admissions")
        self._tev(req, "admit", slot=slot,
                  queue_wait_ms=round(
                      (st.t_admit - req.t_enqueue) * 1e3, 3),
                  migrated_pages=req.kv_import.n_pages,
                  migrated_bytes=req.kv_import.nbytes,
                  prefill_skipped=True)
        # drop the payload reference: the bytes live in the pools now
        req.kv_import = None

    def _account_claim(self, slot: int, st: _SlotState, info) -> None:
        """Fold one admission's prefix-cache outcome into the slot's
        phase plan and the hit-rate accounting."""
        req = st.req
        n = len(req.prompt)
        self._hit_pages += info.hit_pages
        self._prompt_pages += info.prompt_pages
        if info.hit_pages:
            stat_add("decode_prefix_pages_hit", info.hit_pages)
        stat_add("decode_prefix_pages_total", info.prompt_pages)
        total = stat_get("decode_prefix_pages_total")
        if total:
            hits = stat_get("decode_prefix_pages_hit")
            stat_set("decode_cache_hit_rate", int(100 * hits / total))
            stat_set("decode_cache_hit_rate_ppm",
                     int(1e6 * hits / total))
        stat_set("decode_shared_pages", self._cache.shared_pages)
        self._tev(req, "admit", slot=slot,
                  queue_wait_ms=round(
                      (st.t_admit - req.t_enqueue) * 1e3, 3),
                  prompt_pages=info.prompt_pages,
                  fresh_pages=info.fresh_pages,
                  hit_pages=info.hit_pages,
                  hit_tokens=info.hit_tokens,
                  cow_spare=bool(info.partial),
                  prefill_skipped=info.hit_tokens >= n)
        if info.hit_tokens >= n:
            # the ENTIRE prompt is cache-covered: skip prefill — the
            # first decode step re-derives the last prompt position's
            # logits (its K/V write aims at trash: the shared pages
            # already hold that position) and samples the first token
            st.phase = "decode"
            st.write_trash_once = True
            st.last_token = req.prompt[-1]
            st.prefill_pos = n
            self._cache.lengths[slot] = n - 1
            stat_add("decode_prefill_skipped")
        else:
            st.phase = "prefill"
            st.prefill_pos = info.hit_tokens  # page-aligned by design

    def _release(self, slot: int):
        st = self._slots[slot]
        register = None
        if st is not None and self._cache.prefix is not None \
                and st.phase == "decode" \
                and (not self.spec_enabled or st.spec):
            # register this slot's pages for future prefix hits -- only
            # when the draft pools are synced too (a non-speculative slot
            # on a spec engine never wrote draft K/V).  Content = prompt +
            # generated, truncated to the positions actually written,
            # minus any trailing positions a spec slot wrote through the
            # normal step (target-only: the draft bytes there are stale)
            seq = st.req.prompt + st.req.generated
            register = seq[:int(self._cache.lengths[slot]) - st.draft_lag]
        # release BEFORE clearing the slot so the cache's register/
        # evict events can still be attributed to the owning request
        self._cache.release(slot, register_tokens=register)
        self._slots[slot] = None
        stat_set("decode_free_pages", self._cache.allocator.num_free)
        stat_set("decode_shared_pages", self._cache.shared_pages)

    def _export_slot_kv(self, slot: int) -> None:
        """Gather the slot's prompt-covering pages into a migration
        payload on ``req.kv_export`` -- the disagg prefill->decode
        handoff.  Runs on the engine thread right before the slot
        releases, so the pages still hold positions ``0..n-1``."""
        st = self._slots[slot]
        req = st.req
        cc = self._cache.config
        n = len(req.prompt)
        if int(self._cache.lengths[slot]) < n - 1:
            return  # prefill never covered the prompt; router re-runs
        n_pages = cc.pages_for(n)
        pages = self._cache.slot_pages(slot)[:n_pages]
        with otrace.span("serving/migrate_export", slot=slot,
                         pages=n_pages):
            arrays = self._cache.export_pages(pages)
        req.kv_export = kv_cache.KVPageExport(
            n_tokens=n, n_pages=n_pages, src_pages=pages, arrays=arrays,
            quantized=cc.quantized, page_size=cc.page_size)
        stat_add("decode_kv_exports")
        self._tev(req, "kv_export", pages=n_pages,
                  bytes=req.kv_export.nbytes)

    def _finish_slot(self, slot: int, error=None):
        st = self._slots[slot]
        if error is None and st.req.extract_kv and st.phase == "decode":
            # export BEFORE _finish: the handoff thread wakes on the
            # request's completion and must find the payload attached
            try:
                self._export_slot_kv(slot)
            except Exception as e:  # noqa: BLE001 -- a failed export fails
                # the REQUEST (the router re-dispatches), not the engine
                error = e
        if error is None:
            if st.req._finish():
                stat_add("decode_completed")
        else:
            if st.req._finish(error=error):
                stat_add("decode_failed")
        self._release(slot)

    def _reap_live(self):
        """The mid-decode deadline reap: runs at EVERY step boundary so
        a stalled/abandoned client frees its slot now, not after
        max_new_tokens."""
        now = time.monotonic()
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            if st.req.done():  # client-side reap/abandon won the race
                stat_add("decode_abandoned")
                self._release(i)
            elif st.req.expired(now):
                self._expire(st.req, "mid-decode (slot freed)")
                self._release(i)

    def _loop(self):
        # the engine thread owns the pools: it binds its CUDA device and
        # runs every step without autograd
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            self._serve()

    def _serve(self):
        while True:
            with self._cond:
                if self._abort:
                    for i, st in enumerate(self._slots):
                        if st is not None:
                            self._finish_slot(i, ServerClosedError(
                                "engine stopped mid-generation"))
                    return
                self._reap_queue_locked()
                admitted = self._admit_locked()
                if not admitted and not self.live_slots:
                    if self._closing and not self._queue:
                        return
                    # short cap keeps queued deadlines (and a pages-
                    # blocked head) honest while idle
                    self._cond.wait(0.05 if self._queue else None)
                    continue
            self._service_prefills()
            self._reap_live()
            self._run_decode_round()

    # -- device work: prefill ---------------------------------------------
    def _service_prefills(self):
        """Advance prefill-phase slots.  Chunked mode dispatches ONE
        chunk per engine-loop iteration (round-robin across prefilling
        slots) so the decoding slots keep stepping between chunks --
        or, with ragged packing, one fixed-width dispatch of one-row
        lanes dealt across every prefilling slot; unchunked mode
        completes each prefill in one dispatch."""
        pre = [i for i, st in enumerate(self._slots)
               if st is not None and st.phase == "prefill"]
        if not pre:
            return
        chunk = self.config.prefill_chunk_pages
        if chunk > 0 and self.config.ragged_prefill_rows > 0:
            self._run_prefill_ragged(pre)
        elif chunk > 0:
            pick = min(pre, key=lambda i:
                       (i - self._prefill_rr) % self.config.slots)
            self._prefill_rr = (pick + 1) % self.config.slots
            self._run_prefill_rows(pick, chunk * self.config.page_size)
        else:
            for i in pre:
                st = self._slots[i]
                if st.prefill_pos == 0:
                    self._run_prefill_full(i)
                else:
                    # prefix-cache suffix: only the unmatched tail of the
                    # prompt is computed, in one dispatch
                    rows = self._buckets.seq_bucket(
                        len(st.req.prompt) - st.prefill_pos)
                    self._run_prefill_rows(i, rows)

    def _run_prefill_full(self, slot: int):
        """The whole-prompt prefill (no cache hit, chunking off): write
        the padded prompt's K/V page-wholesale into the slot's pages,
        then attend every row through B6 over the slot's page table; a
        speculative slot mirrors the prompt into the draft's pools."""
        st = self._slots[slot]
        req = st.req
        c = self._cache
        try:
            n = len(req.prompt)
            t_pad = self._buckets.seq_bucket(n)
            n_bp = t_pad // c.config.page_size
            tokens = np.zeros((1, t_pad), np.int32)
            tokens[0, :n] = req.prompt
            t0 = time.monotonic()
            with otrace.span("serving/decode_prefill", slot=slot,
                             bucket=t_pad):
                tok_d, table = self._upload(tokens,
                                            c.page_table[slot:slot + 1])
                positions = torch.arange(t_pad, dtype=torch.int32,
                                         device=self.device)[None]
                x = self._rows_forward(
                    self.model, c.target, tok_d, positions, table,
                    self._prompt_writer(c.target, table[0, :n_bp]))
                last = self.model._head(x[0, n - 1])          # [V]
                tok = self._sample_one(req, last, 0)
                if st.spec:
                    # mirror the prefill into the draft's pools (same page
                    # ids) so proposals can read the prompt
                    self._rows_forward(
                        self._draft_model, c.draft, tok_d, positions,
                        table, self._prompt_writer(c.draft, table[0, :n_bp]))
            stat_time("decode_prefill_seconds", time.monotonic() - t0)
            self._tev(req, "prefill", slot=slot, bucket=t_pad, tokens=n,
                      dur_ms=round((time.monotonic() - t0) * 1e3, 3))
            stat_add("decode_prefills")
            record_pad_waste(n, t_pad)
            st.prefill_pos = n
            st.phase = "decode"
            c.lengths[slot] = n
            if req.record_logits:
                req.logits_trace.append(last.float().cpu().numpy())
            self._deliver(slot, tok)
        except Exception as e:  # noqa: BLE001 — fault isolation per req
            stat_add("decode_prefill_errors")
            self._finish_slot(slot, e)

    def _run_prefill_rows(self, slot: int, rows: int):
        """One prefill chunk of ``rows`` positions starting at the
        slot's prefill cursor (page-aligned).  Serves both chunked
        prefill and the prefix-cache suffix (start > 0): B6 reads the
        already-present pages for positions below the cursor.  The
        FINAL chunk samples the request's first token."""
        st = self._slots[slot]
        req = st.req
        c = self._cache
        p = c.config.page_size
        try:
            n = len(req.prompt)
            start = st.prefill_pos
            n_live = min(rows, n - start)
            final = start + n_live >= n
            tokens = np.zeros((1, rows), np.int32)
            tokens[0, :n_live] = req.prompt[start:start + n_live]
            # padded rows write to the trash page (0, 0)
            write_page = np.zeros((rows,), np.int32)
            write_off = np.zeros((rows,), np.int32)
            pos = start + np.arange(n_live)
            write_page[:n_live] = c.page_table[slot][pos // p]
            write_off[:n_live] = pos % p
            t0 = time.monotonic()
            with otrace.span("serving/decode_prefill_chunk", slot=slot,
                             start=start, rows=rows):
                tok_d, table, wp, wo = self._upload(
                    tokens, c.page_table[slot:slot + 1], write_page,
                    write_off)
                positions = start + torch.arange(
                    rows, dtype=torch.int32, device=self.device)[None]
                x = self._rows_forward(
                    self.model, c.target, tok_d, positions, table,
                    self._token_writer(c.target, wp, wo))
                if final:
                    last = self.model._head(x[0, n - 1 - start])  # [V]
                    tok = self._sample_one(req, last, 0)
                if st.spec:
                    self._rows_forward(
                        self._draft_model, c.draft, tok_d, positions,
                        table, self._token_writer(c.draft, wp, wo))
            stat_time("decode_prefill_seconds", time.monotonic() - t0)
            stat_add("prefill_chunks")
            record_pad_waste(n_live, rows)
            self._prefill_chunk_count += 1
            st.chunks += 1
            self._tev(req, "prefill_chunk", slot=slot, start=start,
                      rows=rows, live=n_live, final=final,
                      dur_ms=round((time.monotonic() - t0) * 1e3, 3))
            st.prefill_pos += n_live
            if final:
                stat_add("decode_prefills")
                st.phase = "decode"
                c.lengths[slot] = n
                if req.record_logits:
                    req.logits_trace.append(last.float().cpu().numpy())
                self._deliver(slot, tok)
        except Exception as e:  # noqa: BLE001 — fault isolation per req
            stat_add("decode_prefill_errors")
            self._finish_slot(slot, e)

    def _ragged_picks(self, pre: List[int]):
        """The lane deal of one ragged dispatch: round-robin over the
        prefilling slots in chunk-sized shares -- every slot gets a fair
        share first, then further rounds deal the leftover lanes out
        (all of a prompt's pages are reserved at admission, so one slot
        absorbing several chunks in one dispatch is sound).  Returns
        ``[(slot, start, lanes)]`` and the live lane count; dead lanes
        only remain when the outstanding prefill work is smaller than
        the dispatch."""
        L = self.config.ragged_prefill_rows
        per_slot_cap = self.config.prefill_chunk_pages \
            * self._cache.config.page_size
        order = sorted(pre, key=lambda i:
                       (i - self._prefill_rr) % self.config.slots)
        assigned = {i: 0 for i in order}
        lanes_left = L
        progress = True
        while lanes_left > 0 and progress:
            progress = False
            for i in order:
                st = self._slots[i]
                t = min(len(st.req.prompt) - st.prefill_pos - assigned[i],
                        per_slot_cap, lanes_left)
                if t <= 0:
                    continue
                assigned[i] += t
                lanes_left -= t
                progress = True
        picks = [(i, self._slots[i].prefill_pos, assigned[i])
                 for i in order if assigned[i] > 0]
        return picks, L - lanes_left

    def _run_prefill_ragged(self, pre: List[int]):
        """Pack several prompts' tails into ONE fixed-width dispatch of
        ``ragged_prefill_rows`` one-row lanes: each lane is one (slot,
        position) query row with its own copy of its slot's page-table
        row, its start and its (page, offset) write coords, so the one
        shape per dispatch is kept while the dead rows of padding each
        prompt's chunk are shared across requests.  Lanes of the SAME
        request at consecutive positions are sound because every layer
        writes all rows' K/V before its attention reads
        (``_rows_forward``); dead lanes write to the trash page (page 0)
        and are ignored.  The packed dispatch is shared, so a fault fails
        every packed request."""
        picks, live = self._ragged_picks(pre)
        if not picks:
            return
        L = self.config.ragged_prefill_rows
        c = self._cache
        p = c.config.page_size
        self._prefill_rr = (picks[-1][0] + 1) % self.config.slots
        tokens = np.zeros((L, 1), np.int32)
        start = np.zeros((L, 1), np.int32)
        page_table = np.zeros((L, c.config.pages_per_slot), np.int32)
        write_page = np.zeros((L,), np.int32)
        write_off = np.zeros((L,), np.int32)
        lane = 0
        spec_any = False
        for i, s0, t in picks:
            st = self._slots[i]
            spec_any = spec_any or st.spec
            pos = s0 + np.arange(t)
            tokens[lane:lane + t, 0] = st.req.prompt[s0:s0 + t]
            start[lane:lane + t, 0] = pos
            page_table[lane:lane + t] = c.page_table[i]
            write_page[lane:lane + t] = c.page_table[i][pos // p]
            write_off[lane:lane + t] = pos % p
            lane += t
        try:
            t0 = time.monotonic()
            with otrace.span("serving/decode_prefill_ragged", lanes=L,
                             live=live, slots=len(picks)):
                tok_d, pos_d, table, wp, wo = self._upload(
                    tokens, start, page_table, write_page, write_off)
                x = self._rows_forward(
                    self.model, c.target, tok_d, pos_d, table,
                    self._token_writer(c.target, wp, wo))
                if spec_any:
                    self._rows_forward(
                        self._draft_model, c.draft, tok_d, pos_d, table,
                        self._token_writer(c.draft, wp, wo))
                firsts = {}
                lane = 0
                for i, s0, t in picks:
                    lane += t
                    req = self._slots[i].req
                    if s0 + t >= len(req.prompt):
                        last = self.model._head(x[lane - 1, 0])   # [V]
                        firsts[i] = (last, self._sample_one(req, last, 0))
            stat_time("decode_prefill_seconds", time.monotonic() - t0)
            stat_add("prefill_chunks")
            stat_add("decode_ragged_dispatches")
            record_pad_waste(live, L)
            self._prefill_chunk_count += 1
            dur = round((time.monotonic() - t0) * 1e3, 3)
            for i, s0, t in picks:
                st = self._slots[i]
                req = st.req
                final = i in firsts
                st.chunks += 1
                self._tev(req, "prefill_chunk", slot=i, start=s0, rows=t,
                          live=t, final=final, ragged=True, dur_ms=dur)
                st.prefill_pos += t
                if final:
                    stat_add("decode_prefills")
                    st.phase = "decode"
                    c.lengths[i] = len(req.prompt)
                    last, tok = firsts[i]
                    if req.record_logits:
                        req.logits_trace.append(last.float().cpu().numpy())
                    self._deliver(i, tok)
        except Exception as e:  # noqa: BLE001 — the packed dispatch is
            # shared: fail every packed request, not just one
            stat_add("decode_prefill_errors")
            for i, _s, _t in picks:
                if self._slots[i] is not None:
                    self._finish_slot(i, e)

    # -- device work: decode ----------------------------------------------
    def _deliver(self, slot: int, token: int):
        """Account one sampled token for a live slot; finish + free the
        slot the moment its request is done."""
        st = self._slots[slot]
        now = time.monotonic()
        if st.n_generated > 0:
            stat_time("tpot_seconds", now - st.t_last)
        st.t_last = now
        st.n_generated += 1
        st.last_token = token
        self.tokens_total += 1
        stat_add("decode_tokens_total")
        st.req._emit(token)
        self._tev(st.req, "token", slot=slot, token=int(token),
                  n=st.n_generated)
        eos = self.config.eos_id
        if eos is not None and token == eos:
            st.req.finish_reason = "eos"
            self._finish_slot(slot)
        elif st.n_generated >= st.req.max_new_tokens:
            st.req.finish_reason = "budget"
            self._finish_slot(slot)

    def _perform_cow(self, slot, plans):
        """Run the device half of every planned copy-on-write BEFORE
        the write that needed it (the host tables were already swapped
        by plan_cow)."""
        st = self._slots[slot]
        for src, dst in plans:
            t0 = time.monotonic()
            self._cache.copy_page(src, dst)
            stat_add("decode_cow_copies")
            self._cow_copies += 1
            if st is not None:
                self._tev(st.req, "cow", slot=slot, src=int(src),
                          dst=int(dst),
                          dur_ms=round((time.monotonic() - t0) * 1e3, 3))

    def _run_decode_round(self):
        decoding = [i for i, st in enumerate(self._slots)
                    if st is not None and st.phase == "decode"]
        if not decoding:
            return
        stat_max("decode_slot_occupancy_max", len(decoding))
        spec = [i for i in decoding
                if self._slots[i].spec
                and (self._slots[i].req.max_new_tokens
                     - self._slots[i].n_generated) >= 2]
        if spec:
            self._run_spec(spec)
        normal = [i for i in decoding
                  if self._slots[i] is not None and i not in set(spec)]
        if normal:
            self._run_step(normal)

    def _run_step(self, live_idx):
        c = self._cache.config
        s = c.num_slots
        # copy-on-write any shared page this step would write (a
        # borrowed partial tail at its first divergent token)
        for i in live_idx:
            if not self._slots[i].write_trash_once:
                self._perform_cow(i, self._cache.plan_cow(
                    i, [int(self._cache.lengths[i])]))
        tokens = np.zeros((s,), np.int32)
        positions = np.zeros((s,), np.int32)
        write_page = np.zeros((s,), np.int32)
        write_off = np.zeros((s,), np.int32)
        temp = np.zeros((s,), np.float32)
        top_k = np.zeros((s,), np.int32)
        top_p = np.ones((s,), np.float32)
        gens = [None] * s
        for i in live_idx:
            st = self._slots[i]
            tokens[i] = st.last_token
            positions[i] = self._cache.lengths[i]
            if st.write_trash_once:
                # cache-hit first step: the shared pages already hold
                # this position's K/V — re-deriving it writes identical
                # bytes, but shared pages are immutable, so aim at trash
                write_page[i], write_off[i] = 0, 0
            else:
                write_page[i], write_off[i] = self._cache.write_coords(i)
            temp[i] = st.req.temperature
            top_k[i] = st.req.top_k
            top_p[i] = st.req.top_p
            if st.req.temperature > 0.0:
                gens[i] = token_generator(st.req.seed, st.n_generated,
                                          self.device)
        t0 = time.monotonic()
        try:
            with otrace.span("serving/decode_step", live=len(live_idx)):
                logits = self._decode_step(tokens, positions,
                                           self._cache.page_table,
                                           write_page, write_off)
                nxt = sample_tokens(gens, logits, temp, top_k, top_p)
                nxt = nxt.cpu().numpy()  # THE per-step sync point
        except Exception as e:  # noqa: BLE001 — fail the batch loudly,
            # free every slot, keep the consumer thread alive
            stat_add("decode_step_errors")
            for i in live_idx:
                self._finish_slot(i, e)
            return
        stat_time("decode_step_seconds", time.monotonic() - t0)
        logits_np = None
        for i in live_idx:
            st = self._slots[i]
            st.write_trash_once = False
            if st.spec:
                st.draft_lag += 1  # target-only write: draft is stale
            self._cache.lengths[i] += 1
            if st.req.record_logits:
                if logits_np is None:
                    logits_np = logits.float().cpu().numpy()
                st.req.logits_trace.append(logits_np[i].copy())
            self._deliver(i, int(nxt[i]))
        stat_set("decode_slot_occupancy", self.live_slots)
        stat_add("decode_steps")

    def _run_spec(self, spec_idx):
        """One speculative round for the greedy slots: the draft's k-token
        proposal burst (one captured step) then ONE captured target step
        verifying all k + 1 positions through B6.  Every emitted token is
        the TARGET's argmax at its position in the verify logits;
        proposals only decide how many tokens this round yields (1 to
        k + 1).  The proposals come to the host (the round's first sync)
        to build the verify's tokens and write coords."""
        c = self._cache.config
        s = c.num_slots
        k = self.config.spec_k
        rows = k + 1
        k_live = {}
        for i in spec_idx:
            st = self._slots[i]
            rem = st.req.max_new_tokens - st.n_generated
            k_live[i] = min(k, rem - 1)
            # CoW the pages this round's window writes (skip the
            # trash-aimed first position on the cache-hit path)
            n = int(self._cache.lengths[i])
            lo = n + (1 if st.write_trash_once else 0)
            self._perform_cow(i, self._cache.plan_cow(
                i, range(lo, n + k_live[i] + 1)))
        tok0 = np.zeros((s,), np.int32)
        start = np.zeros((s,), np.int32)
        live = np.zeros((s,), np.int32)
        trash_first = np.zeros((s,), np.int32)
        for i in spec_idx:
            st = self._slots[i]
            tok0[i] = st.last_token
            start[i] = self._cache.lengths[i]
            live[i] = 1
            trash_first[i] = 1 if st.write_trash_once else 0
        t0 = time.monotonic()
        try:
            with otrace.span("serving/decode_spec", live=len(spec_idx),
                             k=k):
                with otrace.span("serving/decode_propose"):
                    props = self._graph_step(
                        "propose", self._propose_forward, tok0, start, live,
                        trash_first, self._cache.page_table)
                    props = props.cpu().numpy()           # [S, k+1]
                tokens = np.zeros((s, rows), np.int32)
                write_page = np.zeros((s, rows), np.int32)
                write_off = np.zeros((s, rows), np.int32)
                for i in spec_idx:
                    tokens[i, 0] = tok0[i]
                    tokens[i, 1:] = props[i, :k]
                    r0 = 1 if trash_first[i] else 0  # row 0 stays trash
                    pos = int(start[i]) + np.arange(r0, k_live[i] + 1)
                    write_page[i, r0:k_live[i] + 1] = \
                        self._cache.page_table[i][pos // c.page_size]
                    write_off[i, r0:k_live[i] + 1] = pos % c.page_size
                with otrace.span("serving/decode_verify"):
                    greedy, logits = self._graph_step(
                        "verify", self._verify_forward, tokens, start,
                        self._cache.page_table, write_page, write_off)
                    greedy = greedy.cpu().numpy()         # [S, k+1]
                    logits_np = None
                    if any(self._slots[i].req.record_logits
                           for i in spec_idx):
                        logits_np = logits.float().cpu().numpy()
        except Exception as e:  # noqa: BLE001 — batch fault isolation
            stat_add("decode_step_errors")
            for i in spec_idx:
                if self._slots[i] is not None:
                    self._finish_slot(i, e)
            return
        stat_time("decode_step_seconds", time.monotonic() - t0)
        proposed = accepted = 0
        for i in spec_idx:
            st = self._slots[i]
            a = 0
            while a < k_live[i] and int(props[i, a]) == int(greedy[i, a]):
                a += 1
            proposed += k_live[i]
            accepted += a
            self._tev(st.req, "spec_round", slot=i, proposed=k_live[i],
                      accepted=a)
            st.write_trash_once = False
            for j in range(a + 1):
                self._cache.lengths[i] += 1
                if st.req.record_logits:
                    st.req.logits_trace.append(logits_np[i, j].copy())
                self._deliver(i, int(greedy[i, j]))
                if self._slots[i] is None:
                    break  # finished (EOS/budget) mid-emission
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        stat_add("decode_spec_proposed", proposed)
        stat_add("decode_spec_accepted", accepted)
        stat_add("decode_spec_rounds")
        total = stat_get("decode_spec_proposed")
        if total:
            acc = stat_get("decode_spec_accepted")
            # integer percent + the float-precision _ppm companion
            stat_set("spec_accept_rate", int(100 * acc / total))
            stat_set("spec_accept_rate_ppm", int(1e6 * acc / total))
        stat_set("decode_slot_occupancy", self.live_slots)

    # -- oracle / observability ------------------------------------------
    def recompute_logits(self, tokens: Sequence[int],
                         quantized: Optional[bool] = None) -> np.ndarray:
        """Full-recompute oracle: run the ENTIRE sequence through the
        model from scratch with plain causal attention over its own K/V
        (no pools, no prefix sharing, no kernel) and return the last
        position's logits.  Touches no engine state, so it is safe to
        call while the engine serves.

        K/V pass through the cache's representation first, as the pages
        store them: ``cache_dtype``, or with ``quantized=True`` the
        per-position int8 quant-dequant round trip.  ``quantized``
        defaults to False: the oracle is the full-precision reference a
        kv-quantized engine's quality delta is measured against.

        Streamed decode agrees with this oracle to a float tolerance,
        not bitwise (see the module docstring)."""
        qz = bool(quantized) if quantized is not None else False
        tokens = [int(t) for t in tokens]
        self._buckets.seq_bucket(len(tokens))  # raises RequestTooLarge
        model, cdt = self.model, self._cache.config.dtype
        n = len(tokens)
        with torch.no_grad():
            tok = torch.as_tensor(tokens, device=self.device)
            pos = torch.arange(n, device=self.device)
            causal = pos[None, :] <= pos[:, None]             # [t, T]
            scale = 1.0 / math.sqrt(model.head_dim)
            x = model._embed(tok, pos)
            for lw in model.layers:
                h = model._ln(x, lw.ln1_g, lw.ln1_b)
                q, k, v = model._qkv(lw, h)                   # [n, H, D]
                if qz:
                    k = kv_cache.dequantize_kv(*kv_cache.quantize_kv(k), cdt)
                    v = kv_cache.dequantize_kv(*kv_cache.quantize_kv(v), cdt)
                else:
                    k, v = k.to(cdt), v.to(cdt)
                s = torch.einsum("thd,Thd->htT", q.float(), k.float()) \
                    * scale
                p = torch.softmax(s.masked_fill(~causal, _NEG_INF), dim=-1)
                ctx = torch.einsum("htT,Thd->thd", p, v.float())
                x = x + model._attn_out(lw, ctx.to(x.dtype))
                x = x + model._mlp(lw, model._ln(x, lw.ln2_g, lw.ln2_b))
            return model._head(x[n - 1]).float().cpu().numpy()

    def debug_requests(self) -> List[dict]:
        """Live in-flight table: one row per occupied slot and per
        queued request — trace id, age, slot, phase, pages held,
        prefill chunks done, tokens emitted, deadline headroom.
        Read-mostly and engine-thread-racy by design."""
        now = time.monotonic()
        rows: List[dict] = []
        for i, st in enumerate(list(self._slots)):
            if st is None:
                continue
            req = st.req
            rows.append({
                "trace_id": req.trace.trace_id
                if req.trace is not None else None,
                "replica": self.name,
                "slot": i,
                "phase": st.phase,
                "age_ms": round((now - req.t_enqueue) * 1e3, 3),
                "prompt_len": len(req.prompt),
                "prefill_pos": st.prefill_pos,
                "chunks_done": st.chunks,
                "pages": len(self._cache.slot_pages(i)),
                "tokens": st.n_generated,
                "max_new_tokens": req.max_new_tokens,
                "speculative": st.spec,
                "deadline_in_ms": None if req.deadline is None
                else round((req.deadline - now) * 1e3, 3),
            })
        with self._cond:
            queued = list(self._queue)
        for req in queued:
            if req.done():
                continue
            rows.append({
                "trace_id": req.trace.trace_id
                if req.trace is not None else None,
                "replica": self.name,
                "slot": None,
                "phase": "queued",
                "age_ms": round((now - req.t_enqueue) * 1e3, 3),
                "prompt_len": len(req.prompt),
                "tokens": 0,
                "max_new_tokens": req.max_new_tokens,
                "deadline_in_ms": None if req.deadline is None
                else round((req.deadline - now) * 1e3, 3),
            })
        return rows

    def stats(self) -> dict:
        with self._cond:
            depth = len(self._queue)
        hp, pp = self._hit_pages, self._prompt_pages
        sp, sa = self._spec_proposed, self._spec_accepted
        return {
            "name": self.name,
            "device": str(self.device),
            "slots": self.config.slots,
            "live_slots": self.live_slots,
            "free_slots": self.free_slots,
            "queue_depth": depth,
            "tokens_total": self.tokens_total,
            "free_pages": self._cache.allocator.num_free,
            "num_pages": self._cache.config.num_pages,
            "cache_bytes": self._cache.config.cache_bytes(),
            "continuous": self._continuous,
            "prefix_cache": self.config.prefix_cache,
            "kv_quant": self.config.kv_quant,
            "page_bytes": self._cache.config.page_bytes(),
            "prefix_hit_pages": hp,
            "prefix_prompt_pages": pp,
            "cache_hit_rate": round(hp / pp, 4) if pp else 0.0,
            "shared_pages": self._cache.shared_pages,
            "cow_copies": self._cow_copies,
            "prefill_chunks": self._prefill_chunk_count,
            "ragged_prefill_rows": self.config.ragged_prefill_rows,
            "ragged_dispatches": stat_get("decode_ragged_dispatches"),
            "prefill_pad_waste": stat_get("prefill_pad_waste") / 1e6,
            "spec_enabled": self.spec_enabled,
            "spec_proposed": sp,
            "spec_accepted": sa,
            "spec_accept_rate": round(sa / sp, 4) if sp else 0.0,
        }
