"""Lowering of the LayerScanPass region ops (framework/passes.py).

Counterpart of ``paddle_tpu/ops/layer_scan.py``.  There ``layer_scan``
is ONE ``jax.lax.scan`` whose body lowers the template block (the first
segment of an isomorphic repeated-layer run) once, traced; here the body
is a loop over ``num_layers`` that lowers the template block's ops once
per layer, eagerly (or into the executor's captured graph), so each
iteration launches exactly the kernels the unrolled layer would, on the
same shapes, in the same order:

- per-layer inputs (xs) are views ``stack[k]`` of their carrier (a slice
  ``xs_start:xs_stop`` of it, walked backwards under ``xs_flip``), or
  the members themselves when they were never stacked (``GatherIn``);
- chained values (carries) pass from layer k to layer k + 1;
- per-layer outputs (ys) go to their carrier in carrier order (reversed
  under ``ys_flip``).  A carrier that is not state (activations for the
  backward scan, gradients for the optimizer scan) is kept as the list
  of the layers' own tensors, no copy, which later ``layer_scan`` ops
  index as they index a stacked tensor; a state carrier that the op
  also reads, at the same index for each layer, is updated in place
  layer by layer; with ``ys_update_start`` a state carrier's slice is
  written in place when the scan is done (a trimmed run updating the
  middle of a wider weight stack); ``ys_pre`` takes a carry's value at
  the START of each iteration; an output that no later op reads is not
  kept at all (XLA drops it from the JAX package's scan);
- random ops draw from the program's generator in the unrolled order,
  so a scanned step equals the unrolled step bit for bit.

Inside the body each value is dropped after its last use in the
template block, as the executor's free plan does for the unrolled
program.  An error in the body is raised again with the inner op's type
and build site.  ``remat_policy`` is checked against the JAX package's
names and recorded: the JAX package wraps the body in ``jax.checkpoint``,
whose primal values are bit-identical either way, and the port's
recompute is program-level (``recompute_configs`` checkpoints), so the
policy changes no number here.

``layer_index`` materializes one per-layer member out of a carrier (a
copy of a state carrier's slice) for the few consumers the pass left
unrolled (an edge layer a trimmed run excluded, a fetch of a mid-stack
activation).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..framework.lowering import LoweringContext, get_lowering, register_lower

# (program id, version, block idx, kept names) -> per-op names freed
_BODY_FREES: Dict[tuple, Tuple[Tuple[str, ...], ...]] = {}
# (program id, version, op id) -> the StackedOut names read after the op
_LIVE: Dict[tuple, frozenset] = {}


def _ints(op, name):
    return [int(v) for v in (op.attr(name, []) or [])]


def _strs(op, name):
    return [str(v) for v in (op.attr(name, []) or [])]


def _body_frees(program, tblock, keep) -> Tuple[Tuple[str, ...], ...]:
    """For each template op, the names nothing after it in the body
    reads (and that are not carried out or stacked)."""
    key = (id(program), program._version, tblock.idx, keep)
    hit = _BODY_FREES.get(key)
    if hit is not None:
        return hit
    last: Dict[str, int] = {}
    for i, top in enumerate(tblock.ops):
        for n in top.input_arg_names() + top.output_arg_names():
            last[n] = i
    frees: List[List[str]] = [[] for _ in tblock.ops]
    for n, i in last.items():
        if n not in keep:
            frees[i].append(n)
    out = _BODY_FREES[key] = tuple(tuple(f) for f in frees)
    return out


def _live_outputs(ctx, op) -> frozenset:
    """The op's stacked outputs that something needs: a later op of the
    block reads them, or they are persistable state.  The JAX package
    emits every stacked output and XLA drops the unread ones; here an
    unread one is never stacked (the executor's free plan would drop it
    right after the op)."""
    from ..framework.executor import op_reads

    program = ctx.program
    key = (id(program), program._version, id(op))
    hit = _LIVE.get(key)
    if hit is not None:
        return hit
    ops = ctx.block.ops
    at = next(i for i, o in enumerate(ops) if o is op)
    reads = {n for later in ops[at + 1:] for n in op_reads(program, later)}
    live = set()
    for n in op.outputs.get("StackedOut", []):
        var = ctx.block._find_var_recursive(n)
        if n in reads or (var is not None and var.persistable):
            live.add(n)
    out = _LIVE[key] = frozenset(live)
    return out


def _layer_at(k, n_layers, start, flip):
    """The carrier index layer ``k`` of a family maps to: a slice from
    ``start`` (-1: the whole carrier), walked backwards under ``flip``."""
    return max(start, 0) + (n_layers - 1 - k if flip else k)


@register_lower("layer_scan")
def _layer_scan(ctx: LoweringContext, op):
    from ..framework.passes import REMAT_POLICIES

    policy = str(op.attr("remat_policy", "") or "")
    if policy and policy not in REMAT_POLICIES:
        raise ValueError(f"layer_scan remat_policy must be one of "
                         f"{sorted(REMAT_POLICIES)}, got {policy!r}")
    program = ctx.program
    tblock = program.blocks[int(op.attr("layer_block"))]
    n_layers = int(op.attr("num_layers"))

    carry_in_tpl = _strs(op, "carry_in_tpl")
    carry_out_tpl = _strs(op, "carry_out_tpl")
    xs_tpl = _strs(op, "xs_tpl")
    xs_src = _strs(op, "xs_src")
    xs_flip = _ints(op, "xs_flip")
    xs_start = _ints(op, "xs_start")
    xs_stop = _ints(op, "xs_stop")
    ys_tpl = _strs(op, "ys_tpl")
    ys_pre = _ints(op, "ys_pre")
    ys_flip = _ints(op, "ys_flip")
    ys_ustart = _ints(op, "ys_update_start")

    # -- the per-layer inputs: xs_vals[i][k] is family i's layer k ---------
    stacked_in = list(op.inputs.get("StackedIn", []))
    gather_in = list(op.inputs.get("GatherIn", []))
    xs_vals = []
    xs_map = {}     # carrier -> {(start, flip) its xs families read by}
    si = gi = 0
    for i in range(len(xs_tpl)):
        if xs_src[i] == "c":
            name = stacked_in[si]
            si += 1
            v = ctx.get(name)
            xs_map.setdefault(name, set()).add((max(xs_start[i], 0),
                                                xs_flip[i]))
            xs_vals.append([v[_layer_at(k, n_layers, xs_start[i],
                                        xs_flip[i])]
                            for k in range(n_layers)])
        else:  # "g": the members exist one by one
            xs_vals.append([ctx.get(n)
                            for n in gather_in[gi:gi + n_layers]])
            gi += n_layers

    # -- where each stacked output goes ------------------------------------
    # (j, name, mode).  A carrier that is not state lives only inside the
    # step, read by later layer_scan ops and layer_index: "list" keeps
    # the layers' own tensors in carrier order, no copy (XLA writes the
    # JAX scan's ys in place).  A state carrier: "inplace" writes layer k
    # into the carrier this op reads, at the index its own xs family
    # reads for layer k (the optimizer updating its own layers); "slice"
    # stacks, then writes the slice of the carrier when the scan is done
    # (any other mapping); "fresh" fills a new [num_layers, ...] tensor
    live = _live_outputs(ctx, op)
    outs = []
    for j, name in enumerate(op.outputs.get("StackedOut", [])):
        if name not in live:
            continue
        var = ctx.block._find_var_recursive(name)
        mapping = (max(ys_ustart[j], 0), ys_flip[j])
        if var is None or not var.persistable:
            mode = "list"
        elif xs_map.get(name) == {mapping}:
            mode = "inplace"
        elif ys_ustart[j] >= 0:
            mode = "slice"
        else:
            mode = "fresh"
        outs.append((j, name, mode))
    bufs = {j: (ctx.get(name) if mode == "inplace" else
                [None] * n_layers if mode == "list" else None)
            for j, name, mode in outs}
    kept = {j: [] for j, _n, mode in outs if mode == "slice"}

    def put(j, k, v):
        if j in kept:
            kept[j].append(v)
            return
        at = _layer_at(k, n_layers, ys_ustart[j], ys_flip[j])
        if isinstance(bufs[j], list):
            bufs[j][at] = v
            return
        if bufs[j] is None:
            bufs[j] = torch.empty((n_layers,) + tuple(v.shape),
                                  dtype=v.dtype, device=v.device)
        bufs[j][at].copy_(v)

    shared = {n: ctx.get(n) for n in op.inputs.get("Shared", [])}
    cvals = [ctx.get(n) for n in op.inputs.get("CarryIn", [])]
    keep = frozenset(ys_tpl[j] for j, _n, _m in outs) | \
        frozenset(carry_out_tpl)
    frees = _body_frees(program, tblock, keep)
    for k in range(n_layers):
        env = dict(shared)
        env.update(zip(carry_in_tpl, cvals))
        env.update((t, vals[k]) for t, vals in zip(xs_tpl, xs_vals))
        # pre-ys (a carry's value at iteration START) before the body
        # may rebind the name
        for j, _n, _m in outs:
            if ys_pre[j]:
                put(j, k, env[ys_tpl[j]])
        bctx = LoweringContext(tblock, env, ctx.device, ctx._generator)
        for top, dead in zip(tblock.ops, frees):
            try:
                get_lowering(top.type)(bctx, top)
            except Exception as e:
                site = top.callstack[-1] if top.callstack else "<unknown>"
                msg = (f"while lowering op {top.type!r} inside layer_scan "
                       f"(built at {site}): {e}")
                try:
                    err = type(e)(msg)
                except Exception:  # noqa: BLE001 - odd constructors
                    err = RuntimeError(msg)
                raise err from e
            for n in dead:
                env.pop(n, None)
        for j, _n, _m in outs:
            if not ys_pre[j]:
                put(j, k, env[ys_tpl[j]])
        cvals = [env[w] for w in carry_out_tpl]

    for name, v in zip(op.outputs.get("CarryOut", []), cvals):
        ctx.set(name, v)
    for j, name, mode in outs:
        if mode == "slice":
            # into that slice of the existing carrier, in place: the rest
            # of it (a trimmed run's edge layers) keeps its values
            vals = kept[j][::-1] if ys_flip[j] else kept[j]
            cur = ctx.get(name)
            cur[ys_ustart[j]:ys_ustart[j] + n_layers].copy_(
                torch.stack(vals))
            ctx.set(name, cur)
        else:
            ctx.set(name, bufs[j])


@register_lower("layer_index")
def _layer_index(ctx: LoweringContext, op):
    x = ctx.in1(op, "X")
    v = x[int(op.attr("index", 0))]
    # a state carrier's slice is copied: the carrier may be updated in
    # place later in the step; a carrier kept as a list holds the layer's
    # own tensor, which nothing writes again
    ctx.set_out(op, "Out", v if isinstance(x, list) else v.clone())
