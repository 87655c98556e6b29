"""Embedding lookup: ``lookup_table_v2`` and the 1.x ``lookup_table``
(dense path).

Counterpart of the dense path of ``paddle_tpu/ops/embedding_ops.py``
(``_lookup_table``): rows of ``W`` picked by ``Ids``, and rows whose id
is ``padding_idx`` zeroed (their gradient with them).  ``lookup_table``
(v1, what ``fluid.layers.embedding`` emits) takes ``Ids`` with a
trailing dimension of 1 and drops it.  The sharded and ``is_sparse``
paths of the JAX package come with the distributed slices of the port:
a table marked row-sharded (``EMB_SHARD_ATTR`` above 1) raises
``parallel_env.later``.
"""
from __future__ import annotations

from ..framework.lowering import register_lower

# the attribute the JAX package's sharding plan stamps on a lookup whose
# table is split by rows over the "mp" axis (its framework/passes.py)
EMB_SHARD_ATTR = "__emb_row_sharded__"


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
    if bool(op.attr("is_sparse", False)):
        raise NotImplementedError(
            "embedding(is_sparse=True) comes with the distributed "
            "embedding, a later slice of the port")
    padding_idx = int(op.attr("padding_idx", -1))
    out = w[ids.long()]
    if padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_out(op, "Out", out)
