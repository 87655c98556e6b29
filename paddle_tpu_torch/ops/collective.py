"""Collective ops: the ``c_*`` ops on the process group, ``dgc`` and
``uncoalesce_tensor``.

Counterpart of ``paddle_tpu/ops/collective.py``.  There each ``c_*`` op
lowers to a ``jax.lax`` collective over the mesh axis its ``ring_id``
names (``psum``, ``pmax``, ``all_gather``, ...), and to the identity when
no mesh axis is in scope.  The port runs one process per card: where a
``torch.distributed`` group is live (``parallel_env.group_live``), each
op calls it, with ring 0 the world group (another ring names a mesh axis
of tensor or pipeline parallelism and raises the later-slice error);
with no group each op is the identity, as before.  Each rule holds to
the JAX rule's semantics:

- ``c_allreduce_{sum,max,min,prod}`` (and ``allreduce``,
  ``mp_allreduce_sum``): ``all_reduce`` with that op;
- ``c_broadcast``: ``broadcast`` from ``root``;
- ``c_allgather``: ``all_gather``, tiled on dim 0 (``c_concat``: on the
  last dim);
- ``c_reducescatter``: the sum, this rank's dim-0 tile of it;
- ``c_reduce_{sum,max,min}``: the reduction lands on ``root_id``; the
  other ranks keep their input (the JAX rule's ``where``);
- ``c_scatter``: ``root``'s tensor broadcast, this rank's dim-0 tile;
  ``c_split`` and ``c_shard_slice``: this rank's tile, no traffic;
- ``barrier``: the group's ``barrier`` (``X`` passed through when the op
  has one); the communicator bootstrap ops ``c_gen_nccl_id``,
  ``c_comm_init``, ``c_comm_init_all``, ``c_sync_calc_stream``,
  ``c_sync_comm_stream``, ``c_wait_comm``, ``c_wait_compute`` stay no-ops
  (``init_parallel_env`` built the communicator).

Every collective works on a buffer of its own on the input's device and
writes the op's output, never a tensor the input shares storage with.
Under NCCL the call goes on the current stream, so a captured step holds
it (``framework/executor.capture_reason``).  Under gloo a collective is a
host call (gloo copies a tensor on the card through the host itself),
and a program holding a collective runs eagerly.  Each call counts ``comm_calls`` and ``comm_bytes`` (the
bytes this rank handed to the group).  ``send_v2`` / ``recv_v2`` /
``partial_send`` / ``partial_recv`` pair ranks of a pipeline and raise
the later-slice error.

``dgc`` (reference operators/dgc_op.cc) and ``uncoalesce_tensor``
compute as the JAX rules do; neither communicates.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from ..monitor import stat_add


def _group(op):
    """The live world group's module for ``op``'s ring, or None without
    a group (the identity)."""
    from ..distributed import parallel_env

    if not parallel_env.group_live():
        return None
    ring = int(op.attr("ring_id", 0) or 0)
    if ring != 0:
        raise parallel_env.later(
            f"op {op.type!r} on ring_id={ring} (a ring other than the "
            f"data-parallel world group names a mesh axis)")
    import torch.distributed as dist

    return dist


def _buf(x: torch.Tensor) -> torch.Tensor:
    """The buffer one collective runs on: a copy of ``x`` of its own on
    ``x``'s device, counted in ``comm_calls`` / ``comm_bytes``."""
    stat_add("comm_calls")
    stat_add("comm_bytes", x.numel() * x.element_size())
    return x.contiguous().clone()


_RED = {"sum": "SUM", "max": "MAX", "min": "MIN", "prod": "PRODUCT"}


def _all_reduce(dist, x, how):
    b = _buf(x)
    dist.all_reduce(b, op=getattr(dist.ReduceOp, _RED[how]))
    return b


def _all_gather(dist, x, axis):
    b = _buf(x)
    parts = [torch.empty_like(b) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, b)
    return torch.cat(parts, dim=axis)


def _tile(dist, x, axis):
    """This rank's tile of ``x`` along ``axis`` (the JAX rules'
    ``dynamic_slice_in_dim`` at ``axis_index * shard``)."""
    n = dist.get_world_size()
    if x.shape[axis] % n:
        raise ValueError(
            f"dim {axis} ({x.shape[axis]}) is not divisible by the "
            f"{n} ranks of the group")
    shard = x.shape[axis] // n
    return x.narrow(axis, dist.get_rank() * shard, shard).clone()


def _allreduce_rule(how):
    def rule(ctx, op):
        x = ctx.in1(op, "X")
        dist = _group(op)
        ctx.set_out(op, "Out", x if dist is None
                    else _all_reduce(dist, x, how))
    return rule


register_lower("c_allreduce_sum", "allreduce",
               "mp_allreduce_sum")(_allreduce_rule("sum"))
register_lower("c_allreduce_max")(_allreduce_rule("max"))
register_lower("c_allreduce_min")(_allreduce_rule("min"))
register_lower("c_allreduce_prod")(_allreduce_rule("prod"))


@register_lower("c_broadcast")
def _c_broadcast(ctx, op):
    x = ctx.in1(op, "X")
    dist = _group(op)
    if dist is None:
        ctx.set_out(op, "Out", x)
        return
    b = _buf(x)
    dist.broadcast(b, src=int(op.attr("root", 0) or 0))
    ctx.set_out(op, "Out", b)


@register_lower("c_allgather")
def _c_allgather(ctx, op):
    x = ctx.in1(op, "X")
    dist = _group(op)
    ctx.set_out(op, "Out", x if dist is None else _all_gather(dist, x, 0))


@register_lower("c_concat")
def _c_concat(ctx, op):
    x = ctx.in1(op, "X")
    dist = _group(op)
    ctx.set_out(op, "Out", x if dist is None
                else _all_gather(dist, x, x.dim() - 1))


@register_lower("c_reducescatter")
def _c_reducescatter(ctx, op):
    x = ctx.in1(op, "X")
    dist = _group(op)
    ctx.set_out(op, "Out", x if dist is None
                else _tile(dist, _all_reduce(dist, x, "sum"), 0))


def _c_reduce(how):
    def rule(ctx, op):
        x = ctx.in1(op, "X")
        dist = _group(op)
        if dist is None:
            ctx.set_out(op, "Out", x)
            return
        root = int(op.attr("root_id", op.attr("root", 0)) or 0)
        red = _all_reduce(dist, x, how)
        # the result lands on root; the other ranks keep their input
        ctx.set_out(op, "Out", red if dist.get_rank() == root else x)
    return rule


register_lower("c_reduce_sum")(_c_reduce("sum"))
register_lower("c_reduce_max")(_c_reduce("max"))
register_lower("c_reduce_min")(_c_reduce("min"))


@register_lower("c_scatter")
def _c_scatter(ctx, op):
    x = ctx.in1(op, "X")
    dist = _group(op)
    if dist is None:
        ctx.set_out(op, "Out", x)
        return
    b = _buf(x)
    dist.broadcast(b, src=int(op.attr("root", 0) or 0))
    ctx.set_out(op, "Out", _tile(dist, b, 0))


@register_lower("c_split")
def _c_split(ctx, op):
    x = ctx.in1(op, "X")
    dist = _group(op)
    ctx.set_out(op, "Out", x if dist is None else _tile(dist, x,
                                                        x.dim() - 1))


@register_lower("c_shard_slice")
def _c_shard_slice(ctx, op):
    x = ctx.in1(op, "X")
    dist = _group(op)
    ctx.set_out(op, "Out", x if dist is None else _tile(dist, x, 0))


@register_lower("c_identity")
def _c_identity(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


@register_lower("barrier")
def _barrier(ctx, op):
    dist = _group(op)
    if dist is not None:
        dist.barrier()
    x = ctx.in1(op, "X")
    if x is not None:
        ctx.set_out(op, "Out", x)


@register_lower("c_gen_nccl_id", "c_comm_init", "c_comm_init_all",
                "c_sync_calc_stream", "c_sync_comm_stream", "c_wait_comm",
                "c_wait_compute")
def _c_noop(ctx, op):
    x = ctx.in1(op, "X")
    if x is not None:
        ctx.set_out(op, "Out", x)


@register_lower("send_v2", "partial_send", "recv_v2", "partial_recv")
def _p2p(ctx, op):
    from ..distributed.parallel_env import later

    raise later(f"op {op.type!r} (point-to-point traffic between "
                f"pipeline stages)")


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
