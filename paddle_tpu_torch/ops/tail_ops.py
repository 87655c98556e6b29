"""Op tail: the linear-chain CRF, spectral norm and the padded select
family (``index_sample``, ``masked_select``, ``sequence_scatter``).

Counterpart of the same lowerings in ``paddle_tpu/ops/tail_ops.py`` (its
pools and ``where_index`` are in ``vision_ops`` and ``nms_ops``).

- Outputs whose reference shape depends on the data have a fixed size:
  ``masked_select``'s ``Y`` keeps X's flat size, the selected values
  first and zeros after, with an int32 ``Count``.
- Index outputs are int32, as in the JAX package.
- The CRF runs its forward algorithm and Viterbi as T-step loops batched
  over B, in log space with a length mask, over dense [B, T, D]
  emissions with a ``Length`` input in place of the reference's LoD
  walk; every step is a few launches on the device, so the program
  captures.
- Indices follow jax's rules on the device (``common.gather_index``,
  ``grad_only_where``, ``scatter_index``, ``take_along_axis``): a bad index never reaches a
  torch gather or scatter, which would assert on the card.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import (gather_index, grad_only_where, scatter_index,
                     take_along_axis)


# ---------------------------------------------------------------------------
# padded select family
# ---------------------------------------------------------------------------

@register_lower("index_sample")
def _index_sample(ctx, op):
    """X [B, N], Index [B, K] -> X[b, Index[b, k]] as
    ``jnp.take_along_axis``: an index from -N up wraps, one outside [-N,
    N) gives NaN (a signed integer X: the type's minimum)."""
    x = ctx.in1(op, "X")
    index = ctx.in1(op, "Index")
    ctx.set_out(op, "Out", take_along_axis(x, index, 1))


@register_lower("masked_select")
def _masked_select(ctx, op):
    """Y keeps X's flat size: the selected values first, in their order
    (a stable sort of the 0 / 1 key ``not mask``), zeros after; ``Count``
    is the number selected, int32.  Nothing is read on the host."""
    x = ctx.in1(op, "X").reshape(-1)
    mask = ctx.in1(op, "Mask").reshape(-1).bool()
    order = torch.sort((~mask).to(torch.int32), stable=True).indices
    ctx.set_out(op, "Y", torch.where(mask[order], x[order],
                                     torch.zeros_like(x)))
    ctx.set_out(op, "Count", mask.sum().to(torch.int32))


@register_lower("sequence_scatter")
def _sequence_scatter(ctx, op):
    """X with Updates added at rows Ids (the dense single-sequence
    contract: a plus-scatter, ``x.at[ids].add`` in the JAX package):
    duplicates add, a negative id wraps once, one still out of range is
    dropped."""
    x = ctx.in1(op, "X")
    ids = ctx.in1(op, "Ids").reshape(-1)
    upd = ctx.in1(op, "Updates").reshape((ids.shape[0],)
                                         + tuple(x.shape[1:]))
    idx, valid = scatter_index(ids, x.shape[0])
    vshape = (-1,) + (1,) * (upd.dim() - 1)
    upd = torch.where(valid.reshape(vshape), upd, torch.zeros_like(upd))
    ctx.set_out(op, "Out", x.index_add(0, idx, upd.to(x.dtype)))


# ---------------------------------------------------------------------------
# spectral norm
# ---------------------------------------------------------------------------

@register_lower("spectral_norm")
def _spectral_norm(ctx, op):
    """Weight / sigma by power iteration from the ``U`` and ``V`` inputs,
    which, as in the JAX package, are not written back.  ``dim`` rotates
    that axis to the front; each normalization is x / (||x|| + eps).
    The gradient differentiates through the iteration, as ``jax.vjp``
    does."""
    w = ctx.in1(op, "Weight")
    u = ctx.in1(op, "U").reshape(-1)
    v = ctx.in1(op, "V").reshape(-1)
    dim = int(op.attr("dim", 0))
    power_iters = int(op.attr("power_iters", 1))
    eps = float(op.attr("eps", 1e-12))
    perm = None
    wm = w
    if dim != 0:
        perm = [dim] + [i for i in range(w.dim()) if i != dim]
        wm = w.permute(perm)
    mat = wm.reshape(wm.shape[0], -1)

    def l2(t):
        return t / (torch.linalg.vector_norm(t) + eps)

    for _ in range(power_iters):
        v = l2(mat.t() @ u)
        u = l2(mat @ v)
    sigma = u @ mat @ v
    out = (mat / sigma).reshape(wm.shape)
    if perm is not None:
        out = out.permute([perm.index(i) for i in range(w.dim())])
    ctx.set_out(op, "Out", out.contiguous())


# ---------------------------------------------------------------------------
# linear-chain CRF
# ---------------------------------------------------------------------------

def _crf_inputs(ctx, op):
    """(emission [B, T, D], 2-D input?, lengths [B] int64 on the device,
    start [D], stop [D], transition [D, D]).  Transition's row 0 is the
    start weights, row 1 the stop weights, rows 2.. the matrix."""
    emission = ctx.in1(op, "Emission")
    transition = ctx.in1(op, "Transition")
    length = ctx.in1(op, "Length")
    squeeze = emission.dim() == 2
    if squeeze:
        emission = emission[None]
    b, t, _d = emission.shape
    if length is None:
        lens = torch.full((b,), t, dtype=torch.int64,
                          device=emission.device)
    else:
        lens = length.reshape(-1).long()
    return (emission, squeeze, lens, transition[0], transition[1],
            transition[2:])


@register_lower("linear_chain_crf")
def _linear_chain_crf(ctx, op):
    """The negative CRF log-likelihood of each sequence (the reference's
    sign: a positive loss), logZ - score(gold path), over dense [B, T,
    D] emissions (or one [T, D] sequence) and ``Length``.  The forward
    algorithm is a T - 1 step loop over the batch in log space; past a
    row's length its alpha stays.  The gold path's last label is
    ``label[n - 1]`` with jax's indexing: a length of 0 reads position
    T - 1 (a negative index wraps), one past T reads T - 1 (clamped).
    ``Alpha`` is zeros and ``EmissionExps`` / ``TransitionExps`` are the
    inputs' ``exp``, as the JAX package gives them; the gradient comes
    from the generic gradient through the loop."""
    emission, _squeeze, lens, start_w, stop_w, trans = _crf_inputs(ctx, op)
    b, t, d = emission.shape
    # jax's indexing: a negative label wraps once, the rest is clamped;
    # the gradient of an array gather (emission, transition) through an
    # out-of-range label is dropped, that of a scalar index (start, stop
    # weights: a dynamic slice) goes to the clamped entry
    label = ctx.in1(op, "Label").reshape(b, t)
    valid = (label >= -d) & (label < d)
    label = gather_index(label, d)
    pos = torch.arange(t, device=emission.device)
    mask = pos[None, :] < lens[:, None]                      # [B, T]

    alpha = start_w[None, :] + emission[:, 0]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, i]
        alpha = torch.where(mask[:, i:i + 1], nxt, alpha)
    logz = torch.logsumexp(alpha + stop_w[None, :], dim=1)

    last = lens - 1
    last = torch.where(last < 0, last + t, last).clamp(0, t - 1)
    last_label = torch.gather(label, 1, last[:, None])[:, 0]
    em = grad_only_where(
        torch.gather(emission, 2, label[:, :, None])[:, :, 0], valid)
    em_score = torch.where(mask, em, torch.zeros_like(em)).sum(1)
    tr = grad_only_where(trans[label[:, :-1], label[:, 1:]],
                         valid[:, :-1] & valid[:, 1:])
    tr_score = torch.where(mask[:, 1:], tr, torch.zeros_like(tr)).sum(1)
    path = start_w[label[:, 0]] + em_score + tr_score + stop_w[last_label]
    ctx.set_out(op, "LogLikelihood", (logz - path).reshape(b, 1))
    ctx.set_out(op, "Alpha", torch.zeros_like(emission))
    ctx.set_out(op, "EmissionExps", torch.exp(emission))
    ctx.set_out(op, "TransitionExps", torch.exp(ctx.in1(op, "Transition")))


@register_lower("crf_decoding")
def _crf_decoding(ctx, op):
    """Viterbi decoding: a T - 1 step loop over the batch keeping
    back-pointers (each the first maximum); past a row's length the
    pointers are identity rows, so the backtrack walks all T - 1 steps
    from the final argmax and the path is zeroed past the length.  With
    ``Label``, the output is the 0 / 1 match of path and label times the
    length mask; a 2-D input gives [T, 1]."""
    emission, squeeze, lens, start_w, stop_w, trans = _crf_inputs(ctx, op)
    b, t, d = emission.shape
    dev = emission.device
    pos = torch.arange(t, device=dev)
    mask = pos[None, :] < lens[:, None]
    ident = torch.arange(d, dtype=torch.int64, device=dev)[None, :]
    score = start_w[None, :] + emission[:, 0]
    back = []
    for i in range(1, t):
        cand = score[:, :, None] + trans[None]             # [B, prev, cur]
        best = cand.amax(dim=1)
        arg = torch.argmax(cand, dim=1)                     # first maximum
        keep = mask[:, i:i + 1]
        score = torch.where(keep, best + emission[:, i], score)
        back.append(torch.where(keep, arg, ident))
    cur = torch.argmax(score + stop_w[None, :], dim=1)      # [B]
    states = [cur]
    for ptr in reversed(back):
        cur = torch.gather(ptr, 1, cur[:, None])[:, 0]
        states.append(cur)
    paths = torch.stack(states[::-1], dim=1)                # [B, T]
    paths = torch.where(mask, paths, torch.zeros_like(paths)).to(torch.int32)
    label = ctx.in1(op, "Label")
    if label is not None:
        out = (paths == label.reshape(b, t).to(torch.int32)).to(torch.int32) \
            * mask.to(torch.int32)
    else:
        out = paths
    ctx.set_out(op, "ViterbiPath", out.reshape(t, 1) if squeeze else out)
