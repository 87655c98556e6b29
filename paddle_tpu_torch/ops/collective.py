"""Collective ops at one rank: the ``c_*`` ops, ``dgc`` and
``uncoalesce_tensor``.

Counterpart of ``paddle_tpu/ops/collective.py``.  There each ``c_*`` op
lowers to a ``jax.lax`` collective over the mesh axis its ``ring_id``
names, and to what it computes with no mesh axis in scope when there is
none (``_axis`` returns None): the identity, which is also the
reference's nranks == 1 behavior.  The port runs one rank and no mesh,
so each rule here is that second branch:

- the identity for ``c_allreduce_{sum,max,min,prod}`` (and
  ``allreduce``, ``mp_allreduce_sum``), ``c_reduce_{sum,max,min}``,
  ``c_broadcast``, ``c_allgather``, ``c_reducescatter``, ``c_scatter``,
  ``c_concat``, ``c_split``, ``c_identity`` and ``c_shard_slice``;
- no-ops (``X`` passed through when the op has one) for ``barrier`` and
  the communicator bootstrap ops ``c_gen_nccl_id``, ``c_comm_init``,
  ``c_comm_init_all``, ``c_sync_calc_stream``, ``c_sync_comm_stream``,
  ``c_wait_comm``, ``c_wait_compute``;
- ``send_v2`` / ``recv_v2`` / ``partial_send`` / ``partial_recv`` need a
  peer and raise the later-slice error (ROADMAP Queue A item 8).

``dgc`` (reference operators/dgc_op.cc) and ``uncoalesce_tensor``
compute as the JAX rules do; neither communicates.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower


def _identity(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


register_lower(
    "c_allreduce_sum", "allreduce", "mp_allreduce_sum", "c_allreduce_max",
    "c_allreduce_min", "c_allreduce_prod", "c_broadcast", "c_allgather",
    "c_reducescatter", "c_reduce_sum", "c_reduce_max", "c_reduce_min",
    "c_scatter", "c_concat", "c_split", "c_identity",
    "c_shard_slice")(_identity)


@register_lower("barrier", "c_gen_nccl_id", "c_comm_init",
                "c_comm_init_all", "c_sync_calc_stream",
                "c_sync_comm_stream", "c_wait_comm", "c_wait_compute")
def _c_noop(ctx, op):
    x = ctx.in1(op, "X")
    if x is not None:
        ctx.set_out(op, "Out", x)


@register_lower("send_v2", "partial_send", "recv_v2", "partial_recv")
def _p2p(ctx, op):
    from ..distributed.parallel_env import later

    raise later(f"op {op.type!r} (point-to-point traffic needs a peer "
                f"rank)")


@register_lower("dgc")
def _dgc(ctx, op):
    """Momentum-corrected top-k gradient sparsification with local
    residual accumulation:

        u = m*u + g;  v = v + u
        mask = |v| among the top k   (k = round(ratio * numel), at least 1)
        encoded = v * mask;  v' = v*(1-mask);  u' = u*(1-mask)

    Before ``rampup_begin_step`` (CurrentStep below it) the dense
    gradient passes through and U, V stay unchanged."""
    g = ctx.in1(op, "Grad")
    u = ctx.in1(op, "U")
    v = ctx.in1(op, "V")
    step = ctx.in1(op, "CurrentStep")
    m = float(op.attr("m", 0.9))
    ratio = float(op.attr("ratio", 0.001))
    rampup_begin = float(op.attr("rampup_begin_step", 0.0))

    u_new = m * u + g
    v_new = v + u_new
    flat = torch.abs(v_new).reshape(-1)
    k = max(1, int(round(ratio * flat.shape[0])))
    thr = torch.topk(flat, k).values[-1]
    mask = (torch.abs(v_new) >= thr).to(g.dtype)
    if step is not None:
        engaged = step.reshape(()) >= rampup_begin
    else:
        engaged = torch.ones((), dtype=torch.bool, device=g.device)
    encoded = torch.where(engaged, v_new * mask, g)
    keep = 1.0 - mask
    ctx.set_out(op, "U_out", torch.where(engaged, u_new * keep, u))
    ctx.set_out(op, "V_out", torch.where(engaged, v_new * keep, v))
    ctx.set_out(op, "EncodeGrad", encoded)
    ctx.set_out(op, "Grad_out", encoded)
    if ctx.out_name(op, "GatherBuff"):
        ctx.set_out(op, "GatherBuff", encoded)


@register_lower("uncoalesce_tensor")
def _uncoalesce_tensor(ctx, op):
    """A fused 1-D buffer split back into its members: ``sections`` gives
    the flat lengths, ``dims`` chunked by ``ranks`` each member's
    shape."""
    fused = ctx.get(op.inputs["Input"][0])
    sections = [int(s) for s in (op.attr("sections", []) or [])]
    dims = [int(d) for d in (op.attr("dims", []) or [])]
    ranks = [int(r) for r in (op.attr("ranks", []) or [])]
    outs = op.outputs.get("Output", [])
    if not (len(outs) == len(sections) == len(ranks)):
        raise ValueError(
            f"uncoalesce_tensor: {len(outs)} outputs vs "
            f"{len(sections)} sections / {len(ranks)} ranks")
    off = di = 0
    for name, n, r in zip(outs, sections, ranks):
        shape = tuple(dims[di:di + r])
        di += r
        ctx.set(name, fused[off:off + n].reshape(shape))
        off += n
