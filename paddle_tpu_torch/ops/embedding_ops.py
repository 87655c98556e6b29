"""Embedding lookup: ``lookup_table_v2`` (dense path).

Counterpart of the dense path of ``paddle_tpu/ops/embedding_ops.py``
(``_lookup_table``): rows of ``W`` picked by ``Ids``, and rows whose id
is ``padding_idx`` zeroed.  The sharded and ``is_sparse`` paths of the
JAX package come with the distributed slices of the port.
"""
from __future__ import annotations

from ..framework.lowering import register_lower


@register_lower("lookup_table_v2")
def _lookup_table(ctx, op):
    w = ctx.in1(op, "W")
    ids = ctx.in1(op, "Ids")
    if bool(op.attr("is_sparse", False)):
        raise NotImplementedError(
            "embedding(is_sparse=True) comes with the distributed "
            "embedding, a later slice of the port")
    padding_idx = int(op.attr("padding_idx", -1))
    out = w[ids.long()]
    if padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_out(op, "Out", out)
