"""Decode-time token samplers for the PyTorch port.

Counterpart of the token samplers in ``paddle_tpu/ops/sampling_ops.py``
(``greedy_sample``, ``filter_top_k_top_p``, ``sample_tokens``).  The
JAX engine threads one PRNG key per request, ``fold_in(key(seed),
token_index)``, so a request's tokens do not depend on its slot, its
batch neighbours or its replica.  The port keeps that property with one
``torch.Generator`` per drawn token, seeded from (request seed, token
index) by :func:`token_generator`, and a draw that reads only its own
row.  JAX's threefry bits cannot be reproduced, so only greedy output
is comparable across the two packages; draws are checked by their
statistics.

It also holds the ``correlation`` lowering (FlowNet's cost volume) and
the sampled losses ``nce`` and ``sample_logits``, as the JAX module
does, with their samplers (``_sampler_prob``, ``_draw_samples``, module
functions a test can replace).  A sampled loss draws one set of classes
for the whole batch from ``op_generator``: a nonzero ``seed`` attr gives
the op a generator of its own (its program then runs eagerly, as any
seeded op's), else it draws from the program's stream.  Its gradient
replays the forward, which can draw again only from a seeded generator:
without a ``seed`` the gradient raises, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower
from .common import device_const, op_generator, take, tdiv
from .common import take_along_axis


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab axis -> int32 token ids (first maximum on
    ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_top_k_top_p(logits: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Mask logits outside the per-row top-k / nucleus-p sets to -inf.

    ``top_k`` [..] int (<= 0 disables) and ``top_p`` [..] float
    (>= 1.0 disables) are per-row tensors on the logits' device.  Ties
    at the threshold logit are kept (the sorted-threshold caveat)."""
    v = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    # top-k: keep logits >= the k-th largest (k clipped into [1, V])
    k_idx = (top_k.to(torch.int64) - 1).clamp(0, v - 1)
    thresh_k = torch.gather(desc, -1, k_idx[..., None])
    keep_k = (top_k <= 0)[..., None] | (logits >= thresh_k)
    # top-p: over the sorted distribution keep the minimal prefix whose
    # mass reaches p (the first token is always kept: cum - prob < p)
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[..., None]
    inf = torch.tensor(float("inf"), dtype=desc.dtype, device=desc.device)
    thresh_p = torch.where(keep_sorted, desc, inf).min(
        dim=-1, keepdim=True).values
    keep_p = (top_p >= 1.0)[..., None] | (logits >= thresh_p)
    return torch.where(keep_k & keep_p, logits, -inf)


_M64 = (1 << 64) - 1


def _mix(seed: int, index: int) -> int:
    """splitmix64 of (seed, index): every bit of the result depends on
    both, so a generator that reads only the low 32 bits of its seed
    (the CPU's Mersenne Twister) still tells (seed, index) pairs apart."""
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(index) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def token_generator(seed: int, index: int,
                    device: torch.device) -> torch.Generator:
    """The generator of one request's ``index``-th token: seeded from
    (seed, index) alone, never from the slot or the batch."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix(seed, index))
    return g


def sample_tokens(generators: Sequence[Optional[torch.Generator]],
                  logits: torch.Tensor, temperature, top_k,
                  top_p) -> torch.Tensor:
    """One int32 token per row: greedy where ``temperature <= 0``, else
    a draw from the temperature-scaled, top-k/top-p-filtered
    distribution with that row's generator.  ``logits`` [S, V];
    ``temperature``/``top_k``/``top_p`` [S] host arrays (the scheduler's
    per-request settings: on the host the sampler picks the rows that
    draw without waiting for the device); ``generators[i]`` serves row
    i and may be None for greedy rows."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    out = greedy_sample(logits)
    rows = torch.nonzero(temperature > 0.0).flatten().tolist()
    if not rows:
        return out
    dev = logits.device
    idx = torch.as_tensor(rows, device=dev)
    t = temperature[rows].to(dev)
    filt = filter_top_k_top_p(
        logits[idx].float() / t[:, None],
        torch.as_tensor(top_k)[rows].to(dev),
        torch.as_tensor(top_p, dtype=torch.float32)[rows].to(dev))
    probs = torch.softmax(filt, dim=-1)
    for j, i in enumerate(rows):
        if generators[i] is None:
            raise ValueError(f"row {i} samples at temperature "
                             f"{float(temperature[i])} but has no generator")
        out[i] = torch.multinomial(probs[j], 1,
                                   generator=generators[i])[0].to(torch.int32)
    return out


@register_lower("correlation")
def _correlation(ctx, op):
    """FlowNet correlation cost volume (reference correlation_op.cu):
    for each displacement in the ``max_displacement`` neighbourhood (a
    multiple of ``stride2``), the channel mean of x1(p) * x2(p + d) over
    the padded frame, box-filtered over ``kernel_size`` x
    ``kernel_size`` patches when it is above 1; an even
    ``kernel_size`` raises.  The JAX lowering's geometry: the output
    and the sample centers are bounded by max_displacement + the
    kernel's radius, and x2 is shifted as ``roll`` shifts it (indices
    modulo the padded frame).  Only the rows and columns the output
    reads are formed: x1's band, and x2's at each row shift with every
    column shift as a window view."""
    x1 = ctx.in1(op, "Input1")  # [N, C, H, W]
    x2 = ctx.in1(op, "Input2")
    pad = int(op.attr("pad_size", 0))
    ks = int(op.attr("kernel_size", 1))
    max_disp = int(op.attr("max_displacement", 1))
    stride1 = int(op.attr("stride1", 1))
    stride2 = int(op.attr("stride2", 1))
    if ks % 2 == 0:
        raise NotImplementedError("correlation kernel_size must be odd")
    kr = (ks - 1) // 2
    _n, _c, h, w = x1.shape
    # over-pad by the kernel radius so centered windows at every sampled
    # position (and every displacement) stay in bounds
    pw = pad + kr
    x1p = F.pad(x1, [pw] * 4)
    x2p = F.pad(x2, [pw] * 4)
    hp, wp = x1p.shape[2], x1p.shape[3]
    radius = max_disp // stride2
    disps = [i * stride2 for i in range(-radius, radius + 1)]
    border = max_disp + kr
    oh = -(-(h + 2 * pad - 2 * border) // stride1)  # ceil div
    ow = -(-(w + 2 * pad - 2 * border) // stride1)
    dev = x1.device
    if ks > 1:
        # the band the box filter reads, filtered at stride1: its
        # corners land on the sample centers
        rows = torch.arange(border, border + stride1 * (oh - 1) + ks,
                            device=dev)
        cols, step = border, 1
        n_cols = stride1 * (ow - 1) + ks
    else:
        rows = border + stride1 * torch.arange(oh, device=dev)
        cols, step, n_cols = border, stride1, ow
    a = x1p.index_select(2, rows)
    a = a[..., cols:cols + step * (n_cols - 1) + 1:step]
    # x2's columns at every displacement: one gather a row shift (indices
    # modulo the frame), then a window view, displacement last
    span = 2 * radius * stride2
    ext = (torch.arange(cols - radius * stride2,
                        cols + step * (n_cols - 1) + span - radius * stride2
                        + 1, device=dev)) % wp
    outs = []
    for dy in disps:
        b = x2p.index_select(2, (rows + dy) % hp).index_select(3, ext)
        win = b.unfold(3, span + 1, step)[..., ::stride2]  # [N,C,R,w,D]
        prod = (a[..., None] * win).mean(1).permute(0, 3, 1, 2)  # [N,D,R,w]
        if ks > 1:
            n, d = prod.shape[:2]
            prod = F.avg_pool2d(prod.reshape(n * d, 1, *prod.shape[2:]), ks,
                                stride1, divisor_override=1).reshape(
                n, d, oh, ow) / float(ks * ks)
        outs.append(prod)
    # displacements (dy, dx), dy-major
    ctx.set_out(op, "Output", torch.cat(outs, dim=1))


# -- sampled losses (nce, sample_logits) ------------------------------------


def _sampler_prob(idx, sampler, n_classes, custom_probs=None):
    """P(class) under the sampler: 0 uniform, 1 log-uniform (Zipfian,
    the reference's LogUniformSampler::Probability), 2 the normalized
    ``CustomDistProbs``.  float32, on ``idx``'s device."""
    if sampler == 2:
        return take(custom_probs, idx)
    if sampler == 0:
        return torch.full(tuple(idx.shape), 1.0 / n_classes,
                          dtype=torch.float32, device=idx.device)
    idxf = idx.float()
    return tdiv(torch.log((idxf + 2.0) / (idxf + 1.0)),
                float(np.log(n_classes + 1.0)))


def _draw_samples(ctx, op, n_samples, n_classes):
    """-> (samples [n_samples] int32, their probabilities, the normalized
    custom distribution or None): one draw shared by the batch, from
    ``op_generator``.  Sampler 0 is ``randint``; 1 is ``exp(u * log(n +
    1)) - 1`` cast to int32 and clipped; 2 draws by the inverse CDF,
    ``searchsorted(cumsum(p), u)`` clamped to the last class, on the
    device (the JAX package draws ``categorical``: the same
    distribution), never on a class of probability 0.  The draws are made on ``ctx.device``.  The custom
    distribution is normalized here, once, for the draw and the
    corrections alike."""
    sampler = int(op.attr("sampler", 0))
    gen = op_generator(ctx, op)
    device = ctx.device
    custom_probs = None
    if sampler == 0:
        s = torch.randint(0, n_classes, (n_samples,), generator=gen,
                          device=device, dtype=torch.int32)
    elif sampler == 1:
        u = torch.rand((n_samples,), generator=gen, device=device)
        s = (torch.exp(u * float(np.log(n_classes + 1.0))) - 1.0).to(
            torch.int32).clamp(0, n_classes - 1)
    elif sampler == 2:
        custom_probs = ctx.in1(op, "CustomDistProbs")
        if custom_probs is None:
            raise ValueError(
                f"{op.type} sampler=2 (custom_dist) needs the "
                f"CustomDistProbs input (per-class sampling probabilities)")
        custom_probs = custom_probs.reshape(-1).float()
        custom_probs = custom_probs / custom_probs.sum()
        u = torch.rand((n_samples,), generator=gen, device=device)
        # a class of probability 0 repeats the edge below it exactly (the
        # card's parallel scan may round it apart), so no draw lands on
        # it; a draw past the last edge goes to the last possible class
        live = custom_probs > 0
        cdf = torch.cummax(torch.where(live, torch.cumsum(custom_probs, 0),
                                       torch.zeros_like(custom_probs)),
                           0).values
        classes = torch.arange(custom_probs.shape[0], device=device)
        last = torch.where(live, classes, torch.zeros_like(classes)).amax()
        s = torch.minimum(torch.searchsorted(cdf, u, right=True),
                          last).to(torch.int32)
    else:
        raise NotImplementedError(f"{op.type} sampler {sampler} is unknown")
    return (s, _sampler_prob(s, sampler, n_classes, custom_probs),
            custom_probs)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), finite for
    large x, with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


@register_lower("nce")
def _nce(ctx, op):
    """Noise-contrastive estimation: the softplus logistic loss of each
    row's true classes against ``num_neg_samples`` classes drawn once
    for the batch, each logit less log(k * P_noise).  ``SampleLogits``
    holds the true then the noise logits, ``SampleLabels`` the classes,
    int32.  As in the JAX package, ``SampleWeight``, ``is_sparse`` and
    the remote-prefetch attrs are not read; labels gather as jax gathers
    (``common.take``)."""
    x = ctx.in1(op, "Input")                  # [B, D]
    label = ctx.in1(op, "Label")              # [B, T]
    w = ctx.in1(op, "Weight")                 # [C, D]
    b = ctx.in1(op, "Bias")                   # [C] or None
    n_classes = int(op.attr("num_total_classes"))
    n_neg = int(op.attr("num_neg_samples", 10))
    sampler = int(op.attr("sampler", 0))
    bsz = x.shape[0]
    t = label.shape[1] if label.dim() > 1 else 1
    lbl = label.reshape(bsz, t)
    samples, sample_prob, custom_probs = _draw_samples(
        ctx, op, n_neg, n_classes)
    true_logit = torch.einsum("bd,btd->bt", x, take(w, lbl))
    noise_logit = x @ take(w, samples).t()    # [B, n_neg]
    if b is not None:
        b = b.reshape(-1)
        true_logit = true_logit + take(b, lbl)
        noise_logit = noise_logit + take(b, samples)
    p_true = _sampler_prob(lbl, sampler, n_classes, custom_probs)
    k = float(n_neg)
    true_adj = true_logit - torch.log(k * p_true)
    noise_adj = noise_logit - torch.log(k * sample_prob)[None, :]
    cost = _softplus(-true_adj).sum(1) + _softplus(noise_adj).sum(1)
    ctx.set_out(op, "Cost", cost.reshape(bsz, 1))
    ctx.set_out(op, "SampleLogits", torch.cat([true_logit, noise_logit], 1))
    ctx.set_out(op, "SampleLabels", torch.cat(
        [lbl.to(torch.int32), samples[None].expand(bsz, n_neg)], 1))


@register_lower("sample_logits")
def _sample_logits(ctx, op):
    """Sampled softmax's inputs: the logits of each row's true labels
    and of ``num_samples`` classes drawn once for the batch, less log Q
    (the sampler's probability, the true labels' too), 1e20 subtracted
    where a drawn class is one of the row's labels
    (``remove_accidental_hits``).  The gathers are
    ``jnp.take_along_axis``'s.  ``Samples``, ``SampledLabels``,
    ``LogitsDim`` and ``LabelsDim`` are int32; ``Probabilities`` is Q."""
    logits = ctx.in1(op, "Logits")            # [B, C]
    label = ctx.in1(op, "Labels")             # [B, T]
    n_samples = int(op.attr("num_samples", 10))
    sampler = int(op.attr("sampler", 0))
    bsz, c = logits.shape
    t = label.shape[1]
    dev = logits.device
    samples, prob, custom_probs = _draw_samples(ctx, op, n_samples, c)
    lbl = label.to(torch.int32)
    all_idx = torch.cat([lbl, samples[None].expand(bsz, n_samples)], 1)
    picked = take_along_axis(logits, all_idx, 1)
    if bool(op.attr("remove_accidental_hits", True)):
        acc = (all_idx[:, t:, None] == lbl[:, None, :]).any(-1)
        picked = torch.cat([picked[:, :t], picked[:, t:]
                            + (-1e20) * acc.to(picked.dtype)], 1)
    logq = torch.cat([
        torch.log(_sampler_prob(lbl, sampler, c, custom_probs)),
        torch.log(prob)[None].expand(bsz, n_samples)], 1)
    ctx.set_out(op, "SampledLogits", picked - logq)
    ctx.set_out(op, "SampledLabels", torch.arange(
        t, dtype=torch.int32, device=dev)[None].expand(bsz, t).contiguous())
    ctx.set_out(op, "Samples", all_idx)
    ctx.set_out(op, "Probabilities", torch.exp(logq))
    ctx.set_out(op, "LogitsDim", device_const([bsz, c], torch.int32, dev))
    ctx.set_out(op, "LabelsDim", device_const([bsz, t], torch.int32, dev))
