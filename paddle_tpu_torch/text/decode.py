"""Sequence decoding: greedy and fixed-beam search.

Counterpart of ``paddle_tpu/text/decode.py`` (reference BeamSearchDecoder
and dynamic_decode, python/paddle/fluid/layers/rnn.py:866, :1398): the
same semantics over a plain Python loop of ``max_len`` steps on torch
tensors instead of a ``lax.scan``.  A fixed [batch, beam] lane set;
finished beams extend with ``end_id`` at zero added log-prob, so they
keep competing in the joint top-k like the reference's merged
finished / alive queue.  A step makes no host sync: the loop runs all
``max_len`` steps, as the scan does.

The step function contract:

    step_fn(token_ids, state) -> (logits, new_state)

with ``token_ids`` int64 [N], ``logits`` float [N, vocab] and ``state``
a nested tuple / list / dict of tensors batched on dim 0 (N = batch *
beam for beam search, which reorders it by parent beam every step).
Its shapes may change from step to step (a Transformer's prefix).  Port
``Tensor``s are accepted wherever torch tensors are: they are unwrapped.
"""
from __future__ import annotations

import torch

from ..ops.linalg_ops import backtrack_beams

NEG = -1e9


def _raw(x):
    return getattr(x, "_value", x)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(_raw(tree))


def _ids(init_ids):
    if isinstance(init_ids, torch.Tensor) or hasattr(init_ids, "_value"):
        return _raw(init_ids).long()
    from ..dygraph.base import current_device

    return torch.as_tensor(init_ids, dtype=torch.long,
                           device=current_device())


def greedy_search(step_fn, init_state, init_ids, max_len, end_id):
    """Argmax decoding.

    Args:
        init_ids: [batch] start tokens (BOS).
        max_len: number of generated tokens.
        end_id: EOS token id; generation sticks to EOS once emitted.
    Returns:
        (ids [batch, max_len] int64, scores [batch] float32: the summed
        log-probs of the chosen tokens up to and including EOS).
    """
    cur = _ids(init_ids)
    b = cur.shape[0]
    state = _tree_map(lambda v: v, init_state)
    done = torch.zeros(b, dtype=torch.bool, device=cur.device)
    score = torch.zeros(b, dtype=torch.float32, device=cur.device)
    toks = []
    with torch.no_grad():
        for _ in range(int(max_len)):
            logits, state = step_fn(cur, state)
            logits = _raw(logits)
            state = _tree_map(lambda v: v, state)
            logp = torch.log_softmax(logits.float(), dim=-1)
            tok = torch.where(done, end_id, logits.argmax(dim=-1))
            step_lp = logp.gather(1, tok[:, None])[:, 0]
            score = score + torch.where(done, 0.0, step_lp)
            done = done | (tok == end_id)
            cur = tok
            toks.append(tok)
    return torch.stack(toks, dim=1), score


def beam_search(step_fn, init_state, init_ids, beam_size, max_len, end_id,
                length_penalty=0.0):
    """Fixed-beam search (reference BeamSearchDecoder semantics).

    Args:
        init_state: state batched [batch, ...]; tiled to batch * beam
            (reference tile_beam_merge_with_batch, rnn.py:934).
        init_ids: [batch] BOS tokens.
        beam_size: lanes kept per batch element.
        length_penalty: GNMT alpha; final score =
            log_prob / ((5 + len) / 6) ** alpha.
    Returns:
        (ids [batch, beam, max_len] int64, best beam first;
         scores [batch, beam] float32, the length-penalized log-probs).
    """
    k = int(beam_size)
    cur = _ids(init_ids)
    b, dev = cur.shape[0], cur.device
    state = _tree_map(lambda v: v.repeat_interleave(k, dim=0), init_state)
    cur = cur.repeat_interleave(k)
    # only lane 0 live at first, so step 1 yields k DISTINCT expansions
    log_probs = torch.full((b, k), NEG, dtype=torch.float32, device=dev)
    log_probs[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    base = (torch.arange(b, device=dev) * k)[:, None]
    toks, parents = [], []
    eos_row = None
    with torch.no_grad():
        for _ in range(int(max_len)):
            logits, state = step_fn(cur, state)
            logits = _raw(logits)
            v = logits.shape[-1]
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
            if eos_row is None:
                eos_row = torch.full((v,), NEG, dtype=torch.float32,
                                     device=dev)
                eos_row[end_id] = 0.0
            # finished lanes extend ONLY with end_id at zero cost: their
            # score stays frozen while they compete in the joint top-k
            logp = torch.where(finished[:, :, None], eos_row, logp)
            total = (log_probs[:, :, None] + logp).reshape(b, k * v)
            # a stable sort: the lowest index wins a tie, as in lax.top_k
            top_scores, top_idx = torch.sort(total, dim=1, descending=True,
                                             stable=True)
            top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
            parent = top_idx // v
            token = top_idx % v
            finished = finished.gather(1, parent) | (token == end_id)
            gidx = (base + parent).reshape(-1)
            state = _tree_map(lambda s: s.index_select(0, gidx), state)
            log_probs = top_scores
            cur = token.reshape(-1)
            toks.append(token)
            parents.append(parent)

    # one O(max_len) ancestry walk instead of re-gathering the whole ids
    # buffer every step (shared with the gather_tree lowering)
    ids = backtrack_beams(torch.stack(toks), torch.stack(parents))
    ids = ids.permute(1, 2, 0)  # [T, B, K] -> [B, K, T]

    # length = index of the first EOS + 1, or max_len when never finished
    is_eos = ids == end_id
    first_eos = is_eos.int().argmax(dim=-1)
    lengths = torch.where(is_eos.any(dim=-1), first_eos + 1, int(max_len))
    scores = log_probs
    if length_penalty:
        scores = scores / ((5.0 + lengths.float()) / 6.0) ** float(
            length_penalty)
    order = torch.argsort(-scores, dim=-1, stable=True)
    return ids.gather(1, order[:, :, None].expand_as(ids)), \
        scores.gather(1, order)


def dynamic_decode(decoder_step, init_state, init_ids, max_len, end_id,
                   beam_size=None, **kw):
    """Reference dynamic_decode (rnn.py:1398) role: greedy or beam search
    by ``beam_size``."""
    if beam_size is None or int(beam_size) <= 1:
        return greedy_search(decoder_step, init_state, init_ids, max_len,
                             end_id)
    return beam_search(decoder_step, init_state, init_ids, beam_size,
                       max_len, end_id, **kw)


__all__ = ["greedy_search", "beam_search", "dynamic_decode"]
