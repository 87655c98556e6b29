"""Mixture-of-experts routed FFN: top-k routing, capacity-factor
dispatch, stacked per-expert products, combine.

Counterpart of ``paddle_tpu/ops/moe_ops.py`` (role parity: the
reference's incubate MoE layer; GShard/Switch lineage).  The router
scores every token against E experts, keeps the top-k gates
(renormalized over the k), and claims capacity slots in (choice, token)
order: every token's choice 0 before any token's choice 1, a lower token
index first within a choice (the GShard priority rule); a choice past its
expert's capacity is DROPPED (zero combine weight).  The experts run as
one stacked product pair over a dense ``[E, C, D]`` buffer, a static
shape, so one captured step serves every routing outcome.  The Switch
aux loss is ``E * sum_e f_e * P_e`` (f_e: share of tokens whose top-1
choice is e, stop-gradient; P_e: mean router probability of e), so the
router's gradient reaches ``GateW`` through P_e.

What the port changes, with the same values:

- **Dispatch by index.**  The JAX package builds a dense one-hot
  ``[S, E, C]`` combine tensor and dispatches and combines with two
  einsums over it (at S = 8192, E = 8, C = 2560 that is 671 MB and
  2 x 172 GFLOP a forward against the experts' 86).  Each (expert, slot)
  holds at most one token and each token at most K slots, so the port
  keeps the routing as ``dest [S, K]`` (the flat slot ``e * C + c``, or
  the dump row ``E * C`` for a dropped choice) and ``weight [S, K]``:
  the buffer is an ``index_copy`` of the tokens into their slots, the
  output a gather of each token's K slots weighted and summed.  No
  atomics: the gradients are an ``index_select`` and a scatter onto
  unique rows.  ``moe_router_ref`` still returns the dense combine, built
  from the index form, for tests and callers that want it.
- **Ties.**  ``lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` promises no order, so the router takes K
  ``argmax`` picks (the first maximum each), masking each pick.
- **Capture.**  Every shape is static (the capacity is a function of the
  token count), nothing reads the device from the host.

``FLAGS_moe_alltoall_chunks`` slices the capacity axis of the expert
products into that many chunks, concatenated before the combine: each
slot's computation is independent along that axis, so chunked and
sequential runs agree bit for bit (counted ``moe_alltoall_chunked``; a
capacity the count does not divide counts ``moe_alltoall_fallback``).
In the JAX package the chunks overlap the expert-parallel all-to-all;
the port runs one process, and an ``ep`` stamp (``__moe_ep__``) raises,
naming ROADMAP Queue A item 8.  No hand-written kernel: the stacked
expert products are plain large ``torch.bmm`` calls, as they are XLA
dots (outside any Pallas kernel) in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower

__all__ = [
    "moe_capacity",
    "moe_route",
    "moe_router_ref",
    "moe_ffn_ref",
    "moe_balance_gauges",
]

MOE_EP_ATTR = "__moe_ep__"


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Static per-expert slot count: ceil(S*K/E * factor), >= 1."""
    return max(1, int(math.ceil(
        num_tokens * top_k * capacity_factor / num_experts)))


# ---------------------------------------------------------------------------
# router (shared by the training lowering and serving)
# ---------------------------------------------------------------------------


def _one_hot(idx, n):
    """int64 one-hot over a last axis of ``n`` (a comparison: no check of
    the values on the host, so a captured step can hold it)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).long()


def _top_k_indices(probs, k):
    """``lax.top_k``'s indices: descending, the lower index first among
    equal values (``argmax`` returns the first maximum; each pick is then
    masked below every probability)."""
    left, picks = probs.clone(), []
    for _ in range(k):
        i = torch.argmax(left, dim=-1, keepdim=True)
        picks.append(i)
        left.scatter_(1, i, -1.0)
    return torch.cat(picks, dim=1)


def moe_route(x2d, gate_w, *, num_experts, top_k, capacity_factor):
    """Route [S, D] tokens.  Returns ``(dest [S, K] int64, weight [S, K]
    float32, aux_loss [] float32, expert_load [E] float32, capacity)``:
    ``dest`` is each choice's flat slot ``e * C + c``, or ``E * C`` where
    the choice was dropped (its weight 0)."""
    s = x2d.shape[0]
    e, k = int(num_experts), int(top_k)
    cap = moe_capacity(s, e, k, capacity_factor)
    logits = x2d.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)                       # [S, E]
    gate_idx = _top_k_indices(probs.detach(), k)                # [S, K]
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    counts = torch.zeros(e, dtype=torch.int64, device=x2d.device)
    slots = []
    for choice in range(k):
        oh = _one_hot(gate_idx[:, choice], e)                   # [S, E]
        # slot of each token within its expert: this choice's tokens
        # queue behind every earlier choice's claims
        pos = torch.cumsum(oh, dim=0) - oh + counts[None, :]
        slots.append((pos * oh).sum(dim=-1))                    # [S]
        counts = counts + oh.sum(dim=0)
    slot = torch.stack(slots, dim=1)                            # [S, K]
    kept = (slot < cap) & (gate_vals > 0)
    dest = torch.where(kept, gate_idx * cap + slot,
                       torch.full_like(slot, e * cap))
    weight = torch.where(kept, gate_vals, torch.zeros_like(gate_vals))
    expert_load = (_one_hot(gate_idx, e) * kept[..., None]) \
        .sum(dim=(0, 1)).float()
    # Switch aux loss: top-1 assignment share x mean router probability
    f = _one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    p = probs.mean(dim=0)
    aux_loss = float(e) * torch.sum(f.detach() * p)
    return dest, weight, aux_loss, expert_load, cap


def moe_router_ref(x2d, gate_w, *, num_experts, top_k, capacity_factor):
    """The JAX package's router contract: (combine [S, E, C] float32,
    aux_loss, expert_load [E] float32), the dense combine built from
    :func:`moe_route`'s index form."""
    dest, weight, aux, load, cap = moe_route(
        x2d, gate_w, num_experts=num_experts, top_k=top_k,
        capacity_factor=capacity_factor)
    s, e = dest.shape[0], int(num_experts)
    combine = weight.new_zeros(s, e * cap + 1).scatter(1, dest, weight)
    return combine[:, :e * cap].reshape(s, e, cap), aux, load


# ---------------------------------------------------------------------------
# expert FFN body
# ---------------------------------------------------------------------------


def _expert_ffn(dispatched, w1, b1, w2, b2):
    """[E, C', D] dispatched slots -> [E, C', D] expert outputs; one
    stacked product pair over the experts (``jax.nn.gelu``'s default is
    the tanh approximation)."""
    h = torch.bmm(dispatched, w1) + b1[:, None, :]
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, w2) + b2[:, None, :]


def moe_ffn_ref(x, gate_w, w1, b1, w2, b2, *, num_experts, top_k,
                capacity_factor, chunks=0):
    """Full routed FFN over x [..., D] -> (out [..., D], aux_loss,
    expert_load [E], chunked).  ``chunks`` > 1 slices the capacity axis
    (bit-equal to the sequential schedule)."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    e = int(num_experts)
    dest, weight, aux_loss, expert_load, cap = moe_route(
        x2d, gate_w, num_experts=e, top_k=top_k,
        capacity_factor=capacity_factor)
    s, k = dest.shape
    # dispatch: each kept choice's token into its slot; dropped choices
    # land on the dump row E * C, which nothing reads
    flat = dest.reshape(-1)
    buf = x2d.new_zeros(e * cap + 1, d).index_copy(
        0, flat, x2d.unsqueeze(1).expand(s, k, d).reshape(s * k, d))
    buf = buf[:e * cap].reshape(e, cap, d)

    n = int(chunks or 0)
    chunked = n > 1 and cap % n == 0
    if chunked:
        cc = cap // n
        y = torch.cat([_expert_ffn(buf[:, i * cc:(i + 1) * cc], w1, b1,
                                   w2, b2) for i in range(n)], dim=1)
    else:
        y = _expert_ffn(buf, w1, b1, w2, b2)
    # combine: each token's K slots, weighted (the dump row reads zeros)
    y = torch.cat([y.reshape(e * cap, d), y.new_zeros(1, d)])
    picked = y.index_select(0, flat).reshape(s, k, d)
    out = (weight.to(picked.dtype)[..., None] * picked).sum(dim=1)
    return out.reshape(*lead, d), aux_loss, expert_load, chunked


# ---------------------------------------------------------------------------
# gauges (host-side; bench + serving)
# ---------------------------------------------------------------------------


def moe_balance_gauges(expert_load, num_tokens: int, top_k: int,
                       publish: bool = True):
    """Utilization gauges from one step's kept-token counts: balance =
    mean/max load in ppm (1e6 = perfectly even), dropped fraction of
    routed assignments in ppm.  Published via monitor stat_set."""
    from ..framework.scope import to_numpy

    load = np.asarray(to_numpy(expert_load) if isinstance(
        expert_load, torch.Tensor) else expert_load, dtype=np.float64)
    routed = float(max(1, num_tokens * top_k))
    kept = float(load.sum())
    balance = float(load.mean() / load.max()) if load.max() > 0 else 0.0
    gauges = {
        "moe_expert_balance_ppm": int(balance * 1e6),
        "moe_dropped_fraction_ppm": int(
            max(0.0, 1.0 - kept / routed) * 1e6),
    }
    if publish:
        from ..monitor import stat_set

        for key, val in gauges.items():
            stat_set(key, val)
    return gauges


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


def _dequant_stacked(carrier, scale):
    """Per-expert per-output-channel dequant of a stacked [E, *, O]
    carrier with scale [E, O] (ops/quant_ops.quantize_weight_stacked)."""
    return carrier.to(scale.dtype) * scale[:, None, :]


@register_lower("moe_ffn")
def _moe_ffn_lower(ctx, op):
    from ..framework.flags import flag
    from ..monitor import stat_add

    if op.attr(MOE_EP_ATTR, False):
        from ..distributed.parallel_env import later

        raise later("an expert-parallel moe_ffn (the 'ep' mesh axis)")
    w1, w2 = ctx.in1(op, "W1"), ctx.in1(op, "W2")
    s1, s2 = ctx.in1(op, "W1Scale"), ctx.in1(op, "W2Scale")
    if s1 is not None:
        w1 = _dequant_stacked(w1, s1)
    if s2 is not None:
        w2 = _dequant_stacked(w2, s2)
    chunks = int(flag("moe_alltoall_chunks") or 0)
    out, aux, load, chunked = moe_ffn_ref(
        ctx.in1(op, "X"), ctx.in1(op, "GateW"), w1, ctx.in1(op, "B1"), w2,
        ctx.in1(op, "B2"), num_experts=int(op.attr("num_experts")),
        top_k=int(op.attr("top_k", 1)),
        capacity_factor=float(op.attr("capacity_factor", 1.0)),
        chunks=chunks)
    stat_add("moe_ffn_engaged")
    if chunked:
        stat_add("moe_alltoall_chunked")
    elif chunks > 1:
        stat_add("moe_alltoall_fallback")
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "AuxLoss", aux.reshape(1))
    ctx.set_out(op, "ExpertLoad", load)
