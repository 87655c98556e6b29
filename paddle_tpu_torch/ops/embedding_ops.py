"""Embedding lookup: ``lookup_table_v2`` and the 1.x ``lookup_table``.

Counterpart of ``paddle_tpu/ops/embedding_ops.py`` (``_lookup_table``):
rows of ``W`` picked by ``Ids``, and rows whose id is ``padding_idx``
zeroed (their gradient with them).  ``lookup_table`` (v1, what
``fluid.layers.embedding`` emits) takes ``Ids`` with a trailing
dimension of 1 and drops it.

``is_sparse=True`` on one process takes the JAX package's fallback
(``embedding_lookup_ref`` there): a dense lookup in which an id outside
[0, vocab) and ``padding_idx`` give zero rows and no gradient, counted
``emb_sparse_fallback_dense`` at each run of the lowering and warned
about once a process.  The index stays in range on the device
(``ops/common.py``'s rule), so a bad id never asserts on the card.  A
table marked row-sharded (``EMB_SHARD_ATTR`` above 1) needs several
processes and raises ``parallel_env.later``.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import grad_only_where

# the attribute the JAX package's sharding plan stamps on a lookup whose
# table is split by rows over the "mp" axis (its framework/passes.py)
EMB_SHARD_ATTR = "__emb_row_sharded__"

_warned_sparse_fallback = False


def _warn_sparse_fallback(op):
    """Count every sparse lookup that runs dense; warn once a process."""
    global _warned_sparse_fallback
    from ..monitor import stat_add

    stat_add("emb_sparse_fallback_dense")
    if not _warned_sparse_fallback:
        _warned_sparse_fallback = True
        import warnings

        site = op.callstack[-1] if getattr(op, "callstack", None) else "?"
        warnings.warn(
            "embedding(is_sparse=True) has no active sharding plan — "
            "falling back to a dense replicated table (counted "
            "emb_sparse_fallback_dense); the row-sharded table needs "
            f"several processes (op built at {site})", stacklevel=2)


def embedding_lookup_ref(w: torch.Tensor, ids: torch.Tensor,
                         padding_idx: int = -1) -> torch.Tensor:
    """The JAX package's dense reference: ids outside [0, vocab) and
    ``padding_idx`` give zero rows, and their gradient is dropped."""
    keep = (ids >= 0) & (ids < w.shape[0])
    if padding_idx >= 0:
        keep = keep & (ids != padding_idx)
    safe = torch.where(keep, ids, torch.zeros_like(ids)).long()
    out = grad_only_where(w[safe], keep)
    return out * keep.unsqueeze(-1).to(out.dtype)


@register_lower("lookup_table", "lookup_table_v2")
def _lookup_table(ctx, op):
    w = ctx.in1(op, "W")
    ids = ctx.in1(op, "Ids")
    if op.type == "lookup_table" and ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    degree = int(op.attr(EMB_SHARD_ATTR, 0) or 0)
    if degree > 1:
        from ..distributed.parallel_env import later

        raise later(f"{op.type} over a table sharded {degree} ways")
    padding_idx = int(op.attr("padding_idx", -1))
    if bool(op.attr("is_sparse", False)):
        _warn_sparse_fallback(op)
        ctx.set_out(op, "Out", embedding_lookup_ref(w, ids, padding_idx))
        return
    out = w[ids.long()]
    if padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_out(op, "Out", out)
