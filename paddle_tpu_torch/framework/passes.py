"""Program-IR optimization pass pipeline.

Counterpart of ``paddle_tpu/framework/passes.py`` (role parity:
reference build-strategy graph passes, framework/ir/pass.h).  Passes are
*program rewrites applied before lowering*: the Executor clones the
program, runs the pipeline on the clone, and runs the rewritten clone, so
the user's program object is never mutated (with ``FLAGS_fuse_passes=0``
the exact pre-pass program runs).  Application is cached by the Executor
per ``(program.fingerprint(), pass config, fetch/feed names, scope, the
flags the passes read)``.

Passes in default order (the JAX package's registry order; the one it
also registers and the port does not have yet, ``sharding_propagation``,
keeps its place in the comments below and in ROADMAP.md):

1. ``FlashAttentionPass`` -- rewrites the unfused attention chain
   matmul(Q.K^T, alpha) -> [elementwise_add mask] -> softmax -> matmul(.V)
   and its generic grad chain into ``flash_attention`` /
   ``flash_attention_grad`` (``ops/flash_attention.py``: the forward
   kernel keeps only the per-row logsumexp, the two backward kernels
   recompute the probabilities tile by tile).
2. ``LayerScanPass`` -- scan-over-layers, under ``FLAGS_layer_scan`` or
   a ``recompute_configs`` scan stamp: each run of isomorphic layer
   segments becomes one ``layer_scan`` op (``ops/layer_scan.py``) over
   per-layer state stacked into ``@LAYER_STACK@`` carriers
   (``LayerScanPlan``, ``scope.StackedParamRef``); trimmed runs' edge
   layers stay unrolled and read the carriers' slices.
3. ``FuseAllReducePass`` -- bucketed gradient-allreduce fusion: the
   ``c_allreduce_sum`` ops the collective transpiler marked
   (``FUSED_ALLREDUCE_ATTR``) become, a bucket of up to
   ``fuse_grad_size_in_MB`` at a time, ``coalesce_tensor`` -> (cast) ->
   one ``c_allreduce_sum`` -> (cast) -> ``uncoalesce_tensor``; a bucket
   closes at a read barrier, so it composes with the layer-scan
   pull-out.
4. ``RedundantCastEliminationPass`` -- removes ``cast`` ops whose input
   provably already holds the target dtype (a conservative forward
   dataflow; unknown dtypes are never touched).
5. ``DeadOpEliminationPass`` -- drops ops that feed neither a fetch nor
   persistent/scope-resident state, reusing the executor's ``_prune_ops``
   backward slice (side-effect ops are always kept).

``PostTrainingWeightQuantPass`` (``slim/quantization.py``) registers
itself between 1 and 2 (before ``layer_scan``) when the first default pipeline is built
(``_ensure_external_passes``): gated by ``FLAGS_weight_quant`` or
``slim.mark_weight_quant``, it rewrites matmul-family ops onto int8 /
fp8-e4m3 carriers through ``dequant_matmul`` (``ops/quant_ops.py``).

Observability (``paddle_tpu_torch.monitor``):
``pass_flash_attention_fused`` / ``pass_flash_attention_grad_fused``,
``pass_layer_scan_segments`` / ``pass_layer_scan_layers`` /
``pass_layer_scan_skipped`` (+ ``_<reason>``),
``pass_fused_allreduce_buckets`` / ``pass_allreduce_ops_before`` /
``pass_allreduce_ops_after`` / ``pass_overlap_stretched_buckets``,
``pass_casts_removed``,
``pass_dead_ops_removed``,
``pass_pipeline_apply``, and the Executor's ``executor_pass_cache_hit``;
one ``pass/<name>`` tracer span per applied pass.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from . import dtypes

GRAD_SUFFIX = "@GRAD"  # == program.GRAD_SUFFIX (local: no import cycle)

__all__ = [
    "Pass",
    "PassContext",
    "PassPipeline",
    "PASS_REGISTRY",
    "FlashAttentionPass",
    "LayerScanPass",
    "LayerScanPlan",
    "LAYER_SCAN_ATTR",
    "LAYER_SCAN_POLICY_ATTR",
    "LAYER_STACK_ATTR",
    "LAYER_STACK_PREFIX",
    "REMAT_POLICIES",
    "has_tp_marks",
    "has_ep_marks",
    "FuseAllReducePass",
    "FUSED_ALLREDUCE_ATTR",
    "FUSE_SIZE_ATTR",
    "DP_LOSS_SCALE_ATTR",
    "COMM_ID_ATTR",
    "RedundantCastEliminationPass",
    "DeadOpEliminationPass",
    "register_pass",
    "default_pipeline",
    "apply_passes",
]


class PassContext:
    """Per-application context: what the Executor knows at dispatch time.

    ``fetch_names``/``feed_names``/``scope`` feed the dead-op slice and
    the attention pass's refusals; all three join the Executor's
    pass-cache key."""

    def __init__(self, fetch_names: Sequence[str] = (),
                 feed_names: Sequence[str] = (), scope=None):
        self.fetch_names = tuple(fetch_names)
        self.feed_names = tuple(feed_names)
        self.scope = scope
        # per-application scratch for passes (DCE memoizes its prune
        # slice across should_apply/apply)
        self._memo: Dict[tuple, object] = {}


class Pass:
    """One program rewrite.  ``apply`` mutates ``program`` in place and
    returns True iff it changed anything (drives the pipeline's
    copy-on-write: an all-no-op run hands the ORIGINAL program back to
    the Executor)."""

    name = "pass"

    def should_apply(self, program, ctx: PassContext) -> bool:
        return True

    def apply(self, program, ctx: PassContext) -> bool:
        raise NotImplementedError


PASS_REGISTRY: Dict[str, type] = {}


def register_pass(cls=None, *, before: Optional[str] = None):
    """Register a Pass subclass into the ordered default registry and
    rebuild the default pipeline on next use (a registration after the
    first Executor run would otherwise be silently inert).  ``before``
    inserts the pass ahead of an already-registered name instead of
    appending -- how a pass defined outside this module claims its
    pipeline position."""
    if cls is None:
        return lambda c: register_pass(c, before=before)
    global _default_pipeline
    if cls.name in PASS_REGISTRY:
        raise KeyError(f"pass {cls.name!r} already registered")
    if before is None:
        PASS_REGISTRY[cls.name] = cls
    else:
        if before not in PASS_REGISTRY:
            raise KeyError(f"register_pass(before={before!r}): no such "
                           f"registered pass")
        items = []
        for name, c in PASS_REGISTRY.items():
            if name == before:
                items.append((cls.name, cls))
            items.append((name, c))
        PASS_REGISTRY.clear()
        PASS_REGISTRY.update(items)
    _default_pipeline = None
    return cls


# ops that provably hand their (single) input's runtime dtype through to
# every output -- the only ops the cast dataflow tracks through
_DTYPE_PRESERVING = {
    "assign", "c_identity", "c_allreduce_sum", "c_allreduce_max",
    "c_allreduce_min", "c_allreduce_prod", "c_broadcast", "c_allgather",
    "allreduce", "mp_allreduce_sum",
}

# The JAX package's registry holds one more pass, not ported yet:
# sharding_propagation (between flash_attention_fuse and the weight-quant
# pass), which needs a device mesh (ROADMAP Queue A item 8).
# fuse_allreduce registers right after layer_scan, as there.


@register_pass
class RedundantCastEliminationPass(Pass):
    """Remove `cast` ops whose input PROVABLY already holds the target
    dtype (reference delete_cast_op_pass role).

    Conservative forward dataflow: a name's runtime dtype is known only
    when written by a `cast` (the attr names it) or by a
    dtype-preserving op with a known input.  Everything else -- feeds
    included -- starts/resets to unknown: tensor feeds pass through the
    executor WITHOUT dtype coercion, so even a feed's declared var dtype
    is not trustworthy.
    """

    name = "redundant_cast_eliminate"

    def should_apply(self, program, ctx):
        return any(op.type == "cast" for op in program.global_block.ops)

    def apply(self, program, ctx):
        from ..monitor import stat_add
        from .lowering import PSEUDO_OPS
        from .program import Operator

        block = program.global_block
        cur: Dict[str, str] = {}
        new_ops: List = []
        n_removed = 0
        for op in block.ops:
            if op.type in PSEUDO_OPS:
                new_ops.append(op)
                continue
            if op.type == "cast":
                xs = op.inputs.get("X", [])
                outs = op.outputs.get("Out", [])
                dst = None
                try:
                    dst = dtypes.to_str(op.attr("out_dtype"))
                except (KeyError, ValueError, TypeError):
                    pass
                if len(xs) == 1 and len(outs) == 1 and dst is not None:
                    if cur.get(xs[0]) == dst:
                        n_removed += 1
                        if xs[0] == outs[0]:
                            continue  # in-place no-op cast: drop outright
                        op = Operator(block, "assign", {"X": [xs[0]]},
                                      {"Out": [outs[0]]})
                    cur[outs[0]] = dst
                    new_ops.append(op)
                    continue
            if op.type in _DTYPE_PRESERVING:
                ins = op.input_arg_names()
                known = cur.get(ins[0]) if len(ins) == 1 else None
                for n in op.output_arg_names():
                    if known is not None:
                        cur[n] = known
                    else:
                        cur.pop(n, None)
            else:
                for n in op.output_arg_names():
                    cur.pop(n, None)
            new_ops.append(op)
        if not n_removed:
            return False
        block.ops[:] = new_ops
        program._bump()
        stat_add("pass_casts_removed", n_removed)
        return True


@register_pass(before="redundant_cast_eliminate")
class FlashAttentionPass(Pass):
    """Rewrite the unfused attention chain -- matmul(Q.K^T, alpha) ->
    [elementwise_add mask] -> softmax -> matmul(.V) -- plus its generic
    grad chain into the fused ``flash_attention`` /
    ``flash_attention_grad`` ops (ops/flash_attention.py: online-softmax
    forward keeping only per-row statistics, tiled recompute backward,
    one autograd function -- device memory ~O(N) instead of the O(N^2)
    materialized score tensor the plain chain costs).

    Gated by FLAGS_flash_attention ('never' = no rewrite, so the
    flag-off program stays identical to the unfused chain; 'auto'
    rewrites only when the default device is CUDA, so CPU numerics never
    move; the flag's value joins the executor's pass-cache key).

    Conservative refusals -- the chain is left alone when:
    - any intermediate (scores / masked scores / probs, or their grad
      twins) is fetched, persistable, or consumed outside the group
      (e.g. a dropout on the attention probs: the standard flash
      trade-off is no probs dropout);
    - the mask wants gradients (the fused op treats it as a constant
      additive bias);
    - the grad chain is only partially present or its cotangent wiring
      was renamed/summed (fan-out) -- fusing half a backward would
      recompute the other half wrong;
    - shapes/attrs are off-pattern (non-rank-4 operands, transposed
      layouts, non-unit alpha on the probs.V matmul, softmax on a
      non-last axis).
    """

    name = "flash_attention_fuse"

    @staticmethod
    def _engaged():
        import torch

        from . import flags

        mode = str(flags.flag("flash_attention") or "auto")
        if mode == "never":
            return False
        if mode == "always":
            return True
        # a CUDA device standing where the JAX package requires the TPU
        # backend: the port's default device is the card when there is one
        return torch.cuda.is_available()

    def should_apply(self, program, ctx):
        return self._engaged() and any(
            op.type == "softmax" for op in program.global_block.ops)

    # -- chain matching ----------------------------------------------------
    @staticmethod
    def _slot1(op, group, slot):
        ns = op.inputs.get(slot, []) if group == "in" \
            else op.outputs.get(slot, [])
        return ns[0] if len(ns) == 1 else None

    def _match_group(self, block, ops, sm, producers, consumers,
                     fetched, claimed):
        """Match one fwd(+grad) group around a softmax op; returns None
        on any refusal condition."""
        s1 = self._slot1

        def rank(n):
            var = block._find_var_recursive(n)
            return len(var.shape) if var is not None and var.shape else 0

        def persistable(n):
            var = block._find_var_recursive(n)
            return bool(var is not None
                        and getattr(var, "persistable", False))

        masked = s1(sm, "in", "X")
        probs = s1(sm, "out", "Out")
        if not masked or not probs:
            return None
        if int(sm.attr("axis", -1)) not in (-1, rank(probs) - 1):
            return None

        prod = producers.get(masked)
        add = mask = None
        if prod is not None and prod.type == "elementwise_add":
            if int(prod.attr("axis", -1)) != -1:
                return None
            add, mask = prod, s1(prod, "in", "Y")
            scores = s1(prod, "in", "X")
            qk = producers.get(scores) if scores else None
        else:
            scores, qk = masked, prod
        if qk is None or qk.type != "matmul" or id(qk) in claimed:
            return None
        if bool(qk.attr("transpose_X", False)) \
                or not bool(qk.attr("transpose_Y", False)):
            return None
        q, k = s1(qk, "in", "X"), s1(qk, "in", "Y")

        pv = next((c for c in consumers.get(probs, [])
                   if c.type == "matmul"
                   and s1(c, "in", "X") == probs), None)
        if pv is None or bool(pv.attr("transpose_X", False)) \
                or bool(pv.attr("transpose_Y", False)) \
                or float(pv.attr("alpha", 1.0)) != 1.0:
            return None
        v, ctxv = s1(pv, "in", "Y"), s1(pv, "out", "Out")

        names = [q, k, v, scores, probs, ctxv] + ([mask] if add else [])
        if not all(names):
            return None
        if any(rank(n) != 4 for n in (q, k, v)):
            return None
        if add and rank(mask) != 4:
            return None

        fwd = [qk] + ([add] if add else []) + [sm, pv]
        if any(id(m) in claimed for m in fwd):
            return None

        # -- the matching generic grad chain (reverse order) --------------
        def find_grad(t, outname):
            cands = [o for o in ops if o.type == t
                     and s1(o, "in", "Out") == outname]
            return cands[0] if len(cands) == 1 else None

        g_pv = find_grad("matmul_grad", ctxv)
        g_sm = find_grad("softmax_grad", probs)
        g_add = find_grad("elementwise_add_grad", masked) if add else None
        g_qk = find_grad("matmul_grad", scores)
        grads = [g for g in (g_pv, g_sm, g_add, g_qk) if g is not None]
        if grads:
            need = 4 if add else 3
            if len(grads) != need:
                return None  # partial grad chain: refuse, don't half-fuse
            if any(g_add.outputs.get("Y" + GRAD_SUFFIX, [])) \
                    if g_add is not None else False:
                return None  # learnable mask: fused op won't grad it
            if s1(g_pv, "in", "X") != probs or s1(g_pv, "in", "Y") != v \
                    or s1(g_qk, "in", "X") != q \
                    or s1(g_qk, "in", "Y") != k:
                return None
            # cotangent wiring must be the straight-line chain
            gp = (g_pv.outputs.get("X" + GRAD_SUFFIX, [""]) + [""])[0]
            gm = (g_sm.outputs.get("X" + GRAD_SUFFIX, [""]) + [""])[0]
            gs = (g_add.outputs.get("X" + GRAD_SUFFIX, [""])
                  + [""])[0] if g_add is not None else gm
            if s1(g_sm, "in", "Out" + GRAD_SUFFIX) != gp:
                return None
            if g_add is not None and \
                    s1(g_add, "in", "Out" + GRAD_SUFFIX) != gm:
                return None
            if s1(g_qk, "in", "Out" + GRAD_SUFFIX) != gs:
                return None
            grad_inner = [n for n in (gp, gm,
                                      gs if g_add is not None else None)
                          if n]
        else:
            grad_inner = []

        members = fwd + grads
        inner = [scores, probs] + ([masked] if add else []) + grad_inner
        for n in inner:
            if n in fetched or persistable(n):
                return None
            if any(all(c is not m for m in members)
                   for c in consumers.get(n, [])):
                return None  # intermediate escapes the group
        return {
            "fwd": fwd, "grads": grads, "q": q, "k": k, "v": v,
            "mask": mask if add else None, "ctxv": ctxv,
            "alpha": float(qk.attr("alpha", 1.0)),
            "g_pv": g_pv, "g_qk": g_qk,
        }

    def apply(self, program, ctx):
        from ..monitor import stat_add
        from .program import Operator

        block = program.global_block
        ops = list(block.ops)
        pos = {id(op): i for i, op in enumerate(ops)}
        producers, consumers = {}, {}
        for op in ops:
            for n in op.input_arg_names():
                consumers.setdefault(n, []).append(op)
            for n in op.output_arg_names():
                producers[n] = op
        fetched = set(ctx.fetch_names)

        claimed: set = set()
        groups = []
        for sm in ops:
            if sm.type != "softmax":
                continue
            g = self._match_group(block, ops, sm, producers, consumers,
                                  fetched, claimed)
            if g is None:
                continue
            if g["grads"]:
                # moving dv's definition to the grad-group tail is only
                # sound when nothing in between reads it
                tail = pos[id(g["g_qk"])]
                dv = (g["g_pv"].outputs.get(
                    "Y" + GRAD_SUFFIX, [""]) + [""])[0]
                if dv and any(pos[id(c)] < tail
                              for c in consumers.get(dv, [])):
                    continue
            for m in g["fwd"] + g["grads"]:
                claimed.add(id(m))
            groups.append(g)
        if not groups:
            return False

        emit_at, skip = {}, set()
        for g in groups:
            attrs = {"scale": g["alpha"], "causal": False}
            inputs = {"Q": [g["q"]], "K": [g["k"]], "V": [g["v"]]}
            if g["mask"]:
                inputs["Mask"] = [g["mask"]]
            fop = Operator(block, "flash_attention", inputs,
                           {"Out": [g["ctxv"]]}, dict(attrs))
            emit_at[pos[id(g["fwd"][-1])]] = fop
            for m in g["fwd"]:
                skip.add(id(m))
            if g["grads"]:
                g_pv, g_qk = g["g_pv"], g["g_qk"]
                gin = dict(inputs)
                gin["Out"] = [g["ctxv"]]
                gin["Out" + GRAD_SUFFIX] = [
                    self._slot1(g_pv, "in", "Out" + GRAD_SUFFIX)]
                gout = {}
                dq = (g_qk.outputs.get("X" + GRAD_SUFFIX, [""])
                      + [""])[0]
                dk = (g_qk.outputs.get("Y" + GRAD_SUFFIX, [""])
                      + [""])[0]
                dv = (g_pv.outputs.get("Y" + GRAD_SUFFIX, [""])
                      + [""])[0]
                if dq:
                    gout["Q" + GRAD_SUFFIX] = [dq]
                if dk:
                    gout["K" + GRAD_SUFFIX] = [dk]
                if dv:
                    gout["V" + GRAD_SUFFIX] = [dv]
                gattrs = dict(attrs)
                gattrs["__fwd_type__"] = "flash_attention"
                gattrs["__fwd_out_slots__"] = ["Out"]
                gop = Operator(block, "flash_attention_grad", gin, gout,
                               gattrs)
                emit_at[pos[id(g_qk)]] = gop
                for m in g["grads"]:
                    skip.add(id(m))

        new_ops = []
        for i, op in enumerate(ops):
            if i in emit_at:
                new_ops.append(emit_at[i])
            elif id(op) not in skip:
                new_ops.append(op)
        block.ops[:] = new_ops
        program._bump()
        stat_add("pass_flash_attention_fused", len(groups))
        stat_add("pass_flash_attention_grad_fused",
                 sum(1 for g in groups if g["grads"]))
        return True


# ---------------------------------------------------------------------------
# scan-over-layers (the JAX package's LayerScanPass, ops/layer_scan.py)
# ---------------------------------------------------------------------------

# op-attr markers stamped by the transpilers and meta-optimizers, as in
# the JAX package (attrs, so they survive clone/proto round trips and
# join the program fingerprint)
FUSED_ALLREDUCE_ATTR = "__fused_allreduce__"
FUSE_SIZE_ATTR = "__fuse_grad_size_mb__"
DEFAULT_FUSE_MB = 32.0
# stamped by GradAllReduce on its 1/nranks loss-gradient scale op (the
# tensor-parallel meta-optimizer of the JAX package removes it)
DP_LOSS_SCALE_ATTR = "__dp_loss_scale__"
# FuseAllReducePass's stamps on each fused c_allreduce_sum: its stable
# bucket identity, and whether the overlap stretch closed it at its scan
# boundary (observe/phases.py reads both)
COMM_ID_ATTR = "__comm_id__"
COMM_OVERLAP_ATTR = "__comm_overlap__"
TP_RULES_ATTR = "__tp_rules__"
TP_CONSTRAINT_ATTR = "__tp_constraint__"
EP_DEGREE_ATTR = "__ep_degree__"

# scan-over-layers markers.  The first two are stamped by the
# RecomputeMetaOptimizer (DistributedStrategy.recompute_configs
# 'scan_layers' / 'policy') on the program's optimizer ops and OVERRIDE
# the FLAGS_layer_scan* defaults for this program.  LAYER_STACK_ATTR is
# stamped by LayerScanPass on a pulled-out allreduce whose payload
# carries the stacked (num_layers, ...) leading axis over a var whose
# DECLARED shape stays per-layer: byte accounting multiplies by it.
LAYER_SCAN_ATTR = "__layer_scan__"            # min isomorphic run length
LAYER_SCAN_POLICY_ATTR = "__layer_scan_policy__"  # remat policy name
LAYER_STACK_ATTR = "__layer_stack__"          # num stacked layers
# scope/block name prefix of a stacked family's carrier; ckpt
# snapshot_scope skips these (the per-layer StackedParamRef views are
# what checkpoints save, so a resume works across the scan flag)
LAYER_STACK_PREFIX = "@LAYER_STACK@"

# the JAX package's remat policy names (its framework/jax_compat.py
# _CHECKPOINT_POLICY_NAMES): what recompute_configs['policy'] and
# FLAGS_layer_scan_policy accept
REMAT_POLICIES = (
    "nothing_saveable", "dots_saveable", "checkpoint_dots",
    "save_anything", "everything_saveable",
    "dots_with_no_batch_dims_saveable",
)


def has_tp_marks(program) -> bool:
    """True when a TensorParallelMetaOptimizer stamped this program."""
    return any(op.attr(TP_RULES_ATTR) for op in program.global_block.ops)


def has_ep_marks(program) -> bool:
    """True when an ExpertParallelMetaOptimizer stamped this program."""
    return any(op.attr(EP_DEGREE_ATTR) is not None
               for op in program.global_block.ops)


class LayerScanPlan:
    """Scope-side stacker for a layer-scanned program.

    ``stacks`` holds one entry per scope-resident family the
    LayerScanPass stacked (params, optimizer slots): carrier name,
    ordered per-layer member names, per-layer shape and dtype.  The
    Executor calls :meth:`ensure_stacked` on every dispatch before its
    state analysis:

    - first call: the concrete per-layer scope values are stacked into
      one ``(num_layers, *shape)`` carrier tensor on the device (the one
      allocation) and each member becomes a
      :class:`~.scope.StackedParamRef` view, so checkpoints and
      ``paddle.save`` keep seeing per-layer values;
    - steady state (all members are views of the carrier): no-op;
    - concrete members over a live carrier (a restore, a scope filled
      by ``set_var``): each is copied into its slice in place,
      ``carrier[i].copy_(v)`` (the JAX package's ``.at[i].set``), every
      member at once included, so a captured graph that holds the
      carrier as its state buffer keeps reading it.
    """

    __slots__ = ("stacks",)

    def __init__(self, stacks):
        self.stacks = tuple(stacks)

    def ensure_stacked(self, scope, device=None):
        import torch

        from .scope import StackedParamRef, to_tensor

        for st in self.stacks:
            carrier, members = st["carrier"], st["members"]
            shape = tuple(int(d) for d in st["shape"])
            buf = scope.get_var(carrier) if scope.has_var(carrier) \
                else None
            vals, concrete_idx = [], []
            for i, m in enumerate(members):
                v = scope.get_var(m) if scope.has_var(m) else None
                if v is None and buf is None:
                    raise RuntimeError(
                        f"layer-scan stacked state var {m!r} is not "
                        f"initialized in the scope; run the startup "
                        f"program first")
                vals.append(v)
                if v is not None and not (isinstance(v, StackedParamRef)
                                          and v.stack_name == carrier):
                    concrete_idx.append(i)
            if buf is not None and not concrete_idx:
                continue  # steady state
            if buf is not None and tuple(buf.shape) == \
                    (len(members),) + shape:
                # refresh in place: the carrier keeps its storage
                with torch.no_grad():
                    for i in concrete_idx:
                        v = vals[i]
                        if isinstance(v, StackedParamRef):
                            v = v.device_value()
                        buf[i].copy_(to_tensor(v).reshape(shape))
            else:
                # the first pack: the one allocation
                ts = [to_tensor(v.device_value()
                                if isinstance(v, StackedParamRef) else v)
                      for v in vals]
                dev = device if device is not None else ts[0].device
                buf = torch.stack([t.reshape(shape).to(dev) for t in ts])
                scope.set_var(carrier, buf)
            for i, m in enumerate(members):
                scope.set_var(m, StackedParamRef(
                    scope, carrier, i, shape, buf.dtype))

    def __repr__(self):
        return f"LayerScanPlan(stacks={len(self.stacks)})"


# op types that must never sit inside a scanned segment: host I/O,
# control flow (their sub-blocks would need nested region handling),
# positional p2p pairs (a scan would re-order the ring FIFO), and the
# fuse pass's own coalesce machinery
_LS_BREAKER_OPS = {
    "while", "cond_pair", "layer_scan", "layer_index", "feed", "fetch",
    "save", "load", "save_combine", "load_combine", "send_v2",
    "partial_send", "recv_v2", "partial_recv", "barrier", "print",
    "coalesce_tensor", "uncoalesce_tensor",
}
_LS_SUB_BLOCK_ATTRS = ("sub_block", "sub_block_t", "sub_block_f",
                       "layer_block")
# attrs excluded from the isomorphism comparison (placement annotations
# carry no semantics here)
_LS_IGNORED_ATTRS = {"op_device"}


class _LayerStack:
    """One stacked family the pass knows about: ordered member names ->
    carrier.  ``kind``: 'state' (scope-resident, managed by
    LayerScanPlan), 'ys' (produced by a scan in this program), or a
    pending carry stack ('carry_pre'/'carry_post') that only
    materializes a stacked output if something consumes it."""

    __slots__ = ("carrier", "members", "template", "kind", "index_of",
                 "producer", "active")

    def __init__(self, carrier, members, template, kind, producer=None):
        self.carrier = carrier
        self.members = tuple(members)
        self.template = template
        self.kind = kind
        self.index_of = {m: i for i, m in enumerate(self.members)}
        self.producer = producer  # producing _RunPlan for ys/carry kinds
        self.active = kind in ("state", "ys")


class _RunPlan:
    """One accepted isomorphic run, fully planned for emission."""

    __slots__ = ("start", "L", "M", "tpl", "sigmas", "shared", "carries",
                 "xs", "ys", "pulled", "policy")

    def __init__(self, start, L, M, tpl, sigmas):
        self.start = start
        self.L = L
        self.M = M
        self.tpl = tpl          # template ops (program Operators)
        self.sigmas = sigmas    # per segment: {template name -> member}
        self.shared = []        # names identical across segments
        self.carries = []       # (t_tpl, w_tpl) chained pairs
        self.xs = []            # dicts: tpl, members, src, stack, flip,
        #                         slice (start, stop) or None
        self.ys = []            # dicts: tpl, members, pre, stack,
        #                         flip, update_start (None = fresh/full)
        self.pulled = []        # (template allreduce op, ys index)
        self.policy = ""

    @property
    def end(self):
        return self.start + self.L * self.M


@register_pass(before="redundant_cast_eliminate")
class LayerScanPass(Pass):
    """Scan-over-layers: detect maximal runs of isomorphic op segments
    (same op types/slots/attrs/topology, differing only in var names --
    the shape a repeated-layer model builder emits for its forward,
    backward and optimizer regions) and rewrite each run into ONE
    ``layer_scan`` region op (``ops/layer_scan.py``), whose body lowers
    the template segment once per layer over leading-axis-stacked
    per-layer state.

    The JAX package does this to make trace and compile time constant in
    depth (one ``lax.scan`` body); the port keeps the same rewrite, so
    a program's state, checkpoints and counters are the same in both
    packages, and runs the body as a loop over the layers, launching the
    same kernels on the same shapes as the unrolled program (the
    weights are slices of a carrier), in the same order, drawing from
    the program's generator in the same order: step numerics are
    bit-identical to the unrolled run.

    Detection contract (anything else is left untouched, loudly:
    ``pass_layer_scan_skipped`` + a per-reason counter):

    - segments must be attr-identical under a positionally-consistent
      bijective renaming; mapped vars must agree on shape AND dtype
      (stacking needs rectangular families);
    - every template input classifies as shared (same name each layer),
      carry (layer k reads what layer k-1 wrote), or a per-layer xs
      family; every output as carry-out or a per-layer ys family;
    - per-layer weights/slots whose members live in the scope become
      scope-resident stacked carriers (:class:`LayerScanPlan`); grads
      and activations stack as internal ys consumed by later runs (the
      backward scan reads the forward scan's activation stacks, the
      optimizer scan reads the backward's grad stacks);
    - a later run whose families align with an existing stack only on a
      sub-range (layer 0's backward segment differs when the input
      needs no grad) is TRIMMED to the aligned window, the edge layers
      staying unrolled;
    - transpiler-marked per-grad allreduces inside a segment are pulled
      out of the body and re-emitted ONCE on the stacked grad carrier
      (stamped ``LAYER_STACK_ATTR``).
    """

    name = "layer_scan"

    # -- config ------------------------------------------------------------
    @staticmethod
    def _config(program):
        """(enabled, min_layers, policy): program stamps (strategy
        plumbing via RecomputeMetaOptimizer) override the FLAGS_*
        defaults."""
        from .flags import flag

        enabled = bool(flag("layer_scan"))
        min_layers = int(flag("layer_scan_min_layers") or 4)
        policy = str(flag("layer_scan_policy") or "")
        for op in program.global_block.ops:
            # RecomputeMetaOptimizer may stamp scan_layers, policy, or
            # BOTH (recompute_configs={'policy': ...} alone picks the
            # remat policy for a FLAGS_layer_scan-enabled run)
            has_n = op.has_attr(LAYER_SCAN_ATTR)
            p = op.attr(LAYER_SCAN_POLICY_ATTR, None)
            if not (has_n or p):
                continue
            if has_n:
                v = int(op.attr(LAYER_SCAN_ATTR) or 0)
                if v > 0:
                    enabled = True
                    min_layers = v
            if p:
                policy = str(p)
            break
        return enabled, max(min_layers, 2), policy

    def should_apply(self, program, ctx):
        if getattr(program, "_pipeline", None) is not None:
            return False
        enabled, min_layers, _ = self._config(program)
        return enabled and len(program.global_block.ops) >= 2 * min_layers

    # -- structural fingerprints -------------------------------------------
    @staticmethod
    def _is_breaker(op):
        if op.type in _LS_BREAKER_OPS:
            return True
        if any(op.has_attr(a) for a in _LS_SUB_BLOCK_ATTRS):
            return True
        # ZeRO-sharded optimizer state is laid out over the dp axis by
        # name; stacking those members would break the shard specs
        if op.attr("__sharded_accumulators__", None):
            return True
        return False

    @staticmethod
    def _var_sig(block, name):
        v = block._find_var_recursive(name)
        if v is None:
            return ("?",)
        return (tuple(int(s) for s in v.shape), int(v.dtype),
                bool(v.persistable))

    @classmethod
    def _op_key(cls, block, op):
        """Structural fingerprint: everything about the op EXCEPT the
        concrete var names.  Name-bearing attrs (tp constraint anchors)
        are canonicalized positionally against the op's own outputs."""
        out_names = op.output_arg_names()

        def canon_attr(k, v):
            if k == TP_CONSTRAINT_ATTR:
                ents = []
                for ent in (v or []):
                    nm, _, spec = str(ent).partition("\t")
                    if nm in out_names:
                        ents.append((out_names.index(nm), spec))
                    else:
                        ents.append((-1, nm, spec))  # conservative
                return tuple(ents)
            if isinstance(v, (list, tuple)):
                return tuple(v)
            return v

        def slots(d):
            return tuple(
                (s, tuple(cls._var_sig(block, n) for n in names))
                for s, names in sorted(d.items()))

        attrs = tuple(sorted(
            (k, canon_attr(k, v)) for k, v in op.attrs.items()
            if k not in _LS_IGNORED_ATTRS))
        return (op.type, slots(op.inputs), slots(op.outputs), attrs)

    # -- run detection ------------------------------------------------------
    def _find_runs(self, block, ops, min_layers, max_period=256):
        """Non-overlapping (start, period, count) candidates, greedy in
        stream order; candidates are verified/classified later."""
        n = len(ops)
        breaker = [self._is_breaker(op) for op in ops]
        interned: Dict[tuple, int] = {}
        kid = []
        positions: Dict[int, List[int]] = {}
        for i, op in enumerate(ops):
            if breaker[i]:
                kid.append(-1 - i)  # unique: never matches anything
                continue
            k = interned.setdefault(self._op_key(block, op), len(interned))
            kid.append(k)
            positions.setdefault(k, []).append(i)

        runs = []
        i = 0
        while i < n:
            if breaker[i]:
                i += 1
                continue
            limit = min(max_period, (n - i) // min_layers)
            found = None
            for p in positions.get(kid[i], ()):
                L = p - i
                if L <= 0:
                    continue
                if L > limit:
                    break
                if kid[i:i + L] != kid[i + L:i + 2 * L]:
                    continue
                M = 2
                while i + (M + 1) * L <= n \
                        and kid[i + M * L:i + (M + 1) * L] == kid[i:i + L]:
                    M += 1
                if M >= min_layers:
                    found = (L, M)
                    break
            if found:
                L, M = found
                runs.append((i, L, M))
                i += L * M
            else:
                i += 1
        return runs

    # -- renaming + classification -----------------------------------------
    @staticmethod
    def _sigma(tpl_ops, seg_ops):
        """Positional renaming template->segment; None on conflict or
        non-bijectivity."""
        fwd: Dict[str, str] = {}
        rev: Dict[str, str] = {}
        for a, b in zip(tpl_ops, seg_ops):
            for da, db in ((a.inputs, b.inputs), (a.outputs, b.outputs)):
                for slot, names in da.items():
                    other = db.get(slot, [])
                    if len(other) != len(names):
                        return None
                    for x, y in zip(names, other):
                        if fwd.setdefault(x, y) != y:
                            return None
                        if rev.setdefault(y, x) != x:
                            return None
        return fwd

    def _classify(self, ops, start, L, M):
        """Build the run's role model.  Returns (plan, reason): plan is
        a _RunPlan with shared/carries/xs/ys member tuples filled in
        (stack alignment happens later), reason names the rejection."""
        tpl = ops[start:start + L]
        sigmas = []
        for k in range(M):
            s = self._sigma(tpl, ops[start + k * L:start + (k + 1) * L])
            if s is None:
                return None, "rename_conflict"
            sigmas.append(s)

        tpl_writes = list(dict.fromkeys(
            n for op in tpl for n in op.output_arg_names()))
        written = set(tpl_writes)
        ext_in = []
        seen_w: set = set()
        for op in tpl:
            for n in op.input_arg_names():
                if n not in seen_w and n not in ext_in:
                    ext_in.append(n)
            seen_w.update(op.output_arg_names())

        # who writes each member name (cross-segment dependency map)
        write_owner: Dict[str, int] = {}
        for j, s in enumerate(sigmas):
            for w in tpl_writes:
                m = s[w]
                if write_owner.setdefault(m, j) != j:
                    return None, "output_classify"

        plan = _RunPlan(start, L, M, tpl, sigmas)

        def members(t):
            return tuple(s[t] for s in sigmas)

        carry_w: set = set()
        for t in ext_in:
            mem = members(t)
            if all(m == t for m in mem):
                if t in written:
                    return None, "shared_written"
                plan.shared.append(t)
                continue
            cw = None
            for w in tpl_writes:
                if w in carry_w:
                    continue
                if all(sigmas[k][t] == sigmas[k - 1][w]
                       for k in range(1, M)):
                    cw = w
                    break
            if cw is not None and write_owner.get(mem[0]) is None:
                plan.carries.append((t, cw))
                carry_w.add(cw)
                continue
            if len(set(mem)) == M and all(
                    write_owner.get(m, k) == k for k, m in enumerate(mem)):
                # per-layer xs family (a member may be written by its
                # OWN segment -- the in-place optimizer update -- but
                # never by a sibling)
                plan.xs.append({"tpl": t, "members": mem})
                continue
            return None, "input_classify"

        for w in tpl_writes:
            if w in carry_w:
                continue
            mem = members(w)
            if len(set(mem)) != M:
                return None, "output_classify"
            plan.ys.append({"tpl": w, "members": mem, "pre": False})
        return plan, None

    # -- stack alignment ----------------------------------------------------
    @staticmethod
    def _family_window(mem, stacks_of):
        """Longest contiguous segment window [a, b) over which the
        member tuple is either entirely absent from every known stack
        (a fresh family) or maps to a contiguous ascending/descending
        index slice of ONE stack.  Returns (a, b)."""
        n = len(mem)
        best = (0, 0)

        def better(w):
            nonlocal best
            if w[1] - w[0] > best[1] - best[0]:
                best = w

        # fresh runs
        a = None
        for i in range(n + 1):
            fresh = i < n and not stacks_of(mem[i])
            if fresh and a is None:
                a = i
            elif not fresh and a is not None:
                better((a, i))
                a = None

        # mapped runs, per candidate stack
        cands = []
        for m in (mem[0], mem[n // 2], mem[-1]):
            for st in stacks_of(m):
                if st not in cands:
                    cands.append(st)
        for st in cands:
            pos = [st.index_of.get(m) for m in mem]
            a = None
            dirn = 0
            for i in range(n + 1):
                ok = i < n and pos[i] is not None
                if ok and a is not None:
                    step = pos[i] - pos[i - 1]
                    if dirn == 0 and step in (1, -1):
                        dirn = step
                    elif step != dirn:
                        better((a, i))
                        a, dirn = i, 0
                        continue
                if ok and a is None:
                    a, dirn = i, 0
                elif not ok and a is not None:
                    better((a, i))
                    a, dirn = None, 0
        return best

    # -- planning one run ---------------------------------------------------
    def _plan_run(self, block, ops, start, L, M, registry, member_stacks,
                  min_layers, tp_plan, scope):
        """Classify + align a detected run against the stack registry;
        returns (_RunPlan, None) or (None, reason).  Stacks created for
        a run that is ultimately rejected are rolled back so they can
        never serve a later run's alignment."""
        created: List[_LayerStack] = []

        def rollback(reason):
            for st in created:
                registry.pop(st.carrier, None)
                for m in st.members:
                    lst = member_stacks.get(m)
                    if lst and st in lst:
                        lst.remove(st)
            return None, reason

        def stacks_of(name):
            return member_stacks.get(name, ())

        a, b = 0, M
        for _ in range(4):
            plan, reason = self._classify(ops, start + a * L, L, b - a)
            if plan is None:
                return None, reason
            lo, hi = 0, b - a
            for fam in plan.xs:
                wa, wb = self._family_window(fam["members"], stacks_of)
                lo, hi = max(lo, wa), min(hi, wb)
            if hi - lo < min_layers:
                return None, "stack_align"
            if (lo, hi) == (0, b - a):
                break
            a, b = a + lo, a + hi
        else:
            return None, "stack_align"
        plan.start = start + a * L

        # xs: bind to carriers / gather lists
        for fam in plan.xs:
            mem = fam["members"]
            hits = [st for st in stacks_of(mem[0]) if self._slice_of(
                mem, st) is not None]
            if hits:
                st = hits[0]
                s0, flip = self._slice_of(mem, st)
                fam.update(src="c", stack=st, flip=flip,
                           slice=None if (s0 == 0 and len(mem) ==
                                          len(st.members))
                           else (s0, s0 + len(mem)))
                st.active = True
            else:
                if any(stacks_of(m) for m in mem):
                    return rollback("family_mismatch")
                tvar = block._find_var_recursive(fam["tpl"])
                if tvar is None or not tvar.shape:
                    return rollback("var_missing")
                state = all(
                    (lambda v: v is not None and v.persistable)(
                        block._find_var_recursive(m))
                    or (scope is not None and scope.has_var(m))
                    for m in mem)
                if state:
                    st = self._new_stack(block, fam["tpl"], mem, "state",
                                         registry, member_stacks)
                    created.append(st)
                    fam.update(src="c", stack=st, flip=0, slice=None)
                else:
                    fam.update(src="g", stack=None, flip=0, slice=None)
            if tp_plan is not None and not self._tp_uniform(
                    tp_plan, fam["members"]):
                return rollback("tp_spec_mismatch")

        # ys: fresh stacks, or in-place updates of state carriers
        for fam in plan.ys:
            mem = fam["members"]
            upd = None
            for st in stacks_of(mem[0]):
                sl = self._slice_of(mem, st)
                if sl is not None and st.kind == "state":
                    upd = (st, sl)
                    break
            if upd is not None:
                st, (s0, flip) = upd
                fam.update(stack=st, flip=flip,
                           update_start=None if (s0 == 0 and len(mem) ==
                                                 len(st.members) and
                                                 not flip) else s0)
                continue
            if any(stacks_of(m) for m in mem):
                return rollback("ys_conflict")
            st = self._new_stack(block, fam["tpl"], mem, "ys", registry,
                                 member_stacks, producer=plan)
            created.append(st)
            fam.update(stack=st, flip=0, update_start=None)
            if tp_plan is not None and not self._tp_uniform(tp_plan, mem):
                return rollback("tp_spec_mismatch")

        # pending carry stacks: later consumers (the backward scan over
        # forward activations) or outside readers activate them.  BOTH
        # the iteration-start (pre) and iteration-end (post) views are
        # registered -- the backward's activation families span either,
        # depending on whether the chained value is consumed before or
        # after its layer's update -- and only the consumed one ever
        # emits a stacked output
        for (t, w) in plan.carries:
            mem_in = tuple(s[t] for s in plan.sigmas)
            mem_out = tuple(s[w] for s in plan.sigmas)
            for kind, tpl_n, mem in (("carry_pre", t, mem_in),
                                     ("carry_post", w, mem_out)):
                if any(st.members == mem
                       for m in mem for st in member_stacks.get(m, ())):
                    continue  # identical family already registered
                created.append(self._new_stack(
                    block, tpl_n, mem, kind, registry, member_stacks,
                    producer=plan))

        return plan, None

    @staticmethod
    def _slice_of(mem, st):
        """(start, flip) when ``mem`` is a contiguous ascending or
        descending index slice of stack ``st``, else None."""
        pos = [st.index_of.get(m) for m in mem]
        if any(p is None for p in pos):
            return None
        if len(pos) == 1:
            return pos[0], 0
        step = pos[1] - pos[0]
        if step not in (1, -1):
            return None
        if any(pos[i + 1] - pos[i] != step for i in range(len(pos) - 1)):
            return None
        return (pos[0], 0) if step == 1 else (pos[-1], 1)

    @staticmethod
    def _tp_uniform(tp_plan, mem):
        specs = {tuple(tp_plan.specs.get(m, ())) for m in mem}
        return len(specs) == 1

    @staticmethod
    def _new_stack(block, tpl_name, mem, kind, registry, member_stacks,
                   producer=None):
        carrier = LAYER_STACK_PREFIX + tpl_name
        if carrier in registry:
            # same template name reused by a disjoint family (two runs
            # whose templates landed on the same layer): uniquify
            n = 2
            while f"{carrier}#{n}" in registry:
                n += 1
            carrier = f"{carrier}#{n}"
        tvar = block._find_var_recursive(tpl_name)
        # the carrier's DECLARED shape stays per-layer (see
        # LAYER_STACK_ATTR): consumers that need physical bytes must
        # multiply by the stamp
        block.create_var(
            name=carrier,
            shape=list(tvar.shape) if tvar is not None else [],
            dtype=(tvar.dtype if tvar is not None else "float32"),
            persistable=bool(kind == "state"),
            stop_gradient=True)
        st = _LayerStack(carrier, mem, tpl_name, kind, producer=producer)
        registry[carrier] = st
        for m in mem:
            member_stacks.setdefault(m, []).append(st)
        return st

    # -- emission -----------------------------------------------------------
    def _emit_run(self, block, plan, policy, unroll):
        """Emit the layer_scan op (+ pulled-out stacked allreduces) for
        one planned run.  layer_index materializations are appended by
        the caller, which knows the outside readers."""
        from .program import Operator

        program = block.program
        tblock = program._create_block(parent_idx=block.idx)
        program._rollback()

        # pull transpiler-marked in-place grad allreduces out of the
        # body: the scan emits the stacked pre-reduce grads and ONE
        # collective covers all layers (an elementwise sum per layer ==
        # the same sum on the stacked tensor)
        ys_by_tpl = {f["tpl"]: f for f in plan.ys}
        pulled = []
        for j, op in enumerate(plan.tpl):
            if op.type != "c_allreduce_sum" \
                    or not op.attr(FUSED_ALLREDUCE_ATTR):
                continue
            xs_n = op.inputs.get("X", [])
            if len(xs_n) != 1 or op.outputs.get("Out", []) != xs_n:
                continue
            g = xs_n[0]
            fam = ys_by_tpl.get(g)
            if fam is None or fam.get("update_start") is not None \
                    or fam.get("flip"):
                continue
            # nothing later in the body may read the pre-reduce value
            if any(g in later.input_arg_names()
                   for later in plan.tpl[j + 1:]):
                continue
            pulled.append((j, op, fam))
        pulled_idx = {j for j, _, _ in pulled}

        for j, op in enumerate(plan.tpl):
            if j in pulled_idx:
                continue
            top = Operator.__new__(Operator)
            top.block = tblock
            top.type = op.type
            top.inputs = {s: list(n) for s, n in op.inputs.items()}
            top.outputs = {s: list(n) for s, n in op.outputs.items()}
            top.attrs = dict(op.attrs)
            top.callstack = list(op.callstack)
            tblock.ops.append(top)

        sig0, sigN = plan.sigmas[0], plan.sigmas[-1]
        inputs = {}
        outputs = {}
        attrs = {
            "layer_block": tblock.idx,
            "num_layers": plan.M,
        }
        if policy:
            attrs["remat_policy"] = policy
        if unroll != 1:
            attrs["unroll"] = unroll
        if plan.carries:
            inputs["CarryIn"] = [sig0[t] for t, _ in plan.carries]
            outputs["CarryOut"] = [sigN[w] for _, w in plan.carries]
            attrs["carry_in_tpl"] = [t for t, _ in plan.carries]
            attrs["carry_out_tpl"] = [w for _, w in plan.carries]
        if plan.shared:
            inputs["Shared"] = list(plan.shared)

        stacked_in, gather_in = [], []
        xs_tpl, xs_src, xs_flip, xs_start, xs_stop = [], [], [], [], []
        for fam in plan.xs:
            xs_tpl.append(fam["tpl"])
            xs_src.append(fam["src"])
            xs_flip.append(int(fam.get("flip") or 0))
            sl = fam.get("slice")
            xs_start.append(-1 if sl is None else int(sl[0]))
            xs_stop.append(-1 if sl is None else int(sl[1]))
            if fam["src"] == "c":
                stacked_in.append(fam["stack"].carrier)
            else:
                gather_in.extend(fam["members"])
        if xs_tpl:
            attrs.update(xs_tpl=xs_tpl, xs_src=xs_src, xs_flip=xs_flip,
                         xs_start=xs_start, xs_stop=xs_stop)
        if stacked_in:
            inputs["StackedIn"] = stacked_in
        if gather_in:
            inputs["GatherIn"] = gather_in

        ys_tpl, ys_pre, ys_flip, ys_ustart, stacked_out = [], [], [], [], []
        for fam in plan.ys:
            st = fam["stack"]
            if st.kind in ("carry_pre", "carry_post") and not st.active:
                continue  # nobody consumes this carry stack
            ys_tpl.append(fam["tpl"])
            ys_pre.append(int(bool(fam.get("pre"))))
            ys_flip.append(int(fam.get("flip") or 0))
            us = fam.get("update_start")
            ys_ustart.append(-1 if us is None else int(us))
            stacked_out.append(st.carrier)
        if ys_tpl:
            attrs.update(ys_tpl=ys_tpl, ys_pre=ys_pre, ys_flip=ys_flip,
                         ys_update_start=ys_ustart)
            outputs["StackedOut"] = stacked_out

        seq = [Operator(block, "layer_scan", inputs, outputs, attrs)]
        for _, op, fam in pulled:
            ar_attrs = dict(op.attrs)
            ar_attrs[LAYER_STACK_ATTR] = plan.M
            carrier = fam["stack"].carrier
            seq.append(Operator(block, "c_allreduce_sum",
                                {"X": [carrier]}, {"Out": [carrier]},
                                ar_attrs))
        return seq

    # -- apply --------------------------------------------------------------
    def apply(self, program, ctx):
        from ..monitor import stat_add, stat_set
        from .flags import flag

        def skip(reason):
            stat_add("pass_layer_scan_skipped")
            stat_add(f"pass_layer_scan_skipped_{reason}")

        _, min_layers, policy = self._config(program)
        if policy and policy not in REMAT_POLICIES:
            raise ValueError(
                f"layer-scan remat policy must be one of "
                f"{sorted(REMAT_POLICIES)}, got {policy!r}")
        unroll = int(flag("layer_scan_unroll") or 1)
        block = program.global_block
        ops = list(block.ops)

        runs = self._find_runs(block, ops, min_layers)
        if not runs:
            skip("no_repeats")
            return False

        tp_plan = getattr(program, "_tp_plan", None)
        registry: Dict[str, _LayerStack] = {}
        member_stacks: Dict[str, List[_LayerStack]] = {}
        plans: List[_RunPlan] = []
        for (start, L, M) in runs:
            plan, reason = self._plan_run(
                block, ops, start, L, M, registry, member_stacks,
                min_layers, tp_plan, ctx.scope)
            if plan is None:
                skip(reason)
                continue
            plans.append(plan)
        if not plans:
            return False

        # -- validation against the surviving unrolled ops ------------------
        run_ranges = [(p.start, p.end) for p in plans]

        def outside(i):
            return not any(a <= i < b for a, b in run_ranges)

        # an outside op writing an xs member in the carrier's STALE
        # window would be read stale through the stack: drop such plans
        # (their ops fall back to the unrolled stream).  A state stack
        # is packed by ensure_stacked BEFORE the program runs, so any
        # outside write preceding the consuming scan is a hazard; a
        # producer-backed stack (ys / activated carry) is filled DURING
        # the producing run, so only the [producer.end, consumer.start)
        # gap is stale.  Dropping a producer also drops every plan
        # consuming one of its stacks -- iterate to the fixpoint.
        for _ in range(len(plans) + 1):
            outside_writes: Dict[str, List[int]] = {}
            for i, op in enumerate(ops):
                if outside(i):
                    for n in op.output_arg_names():
                        outside_writes.setdefault(n, []).append(i)
            alive = set(id(p) for p in plans)
            bad = []
            for p in plans:
                for fam in p.xs:
                    if fam["src"] != "c":
                        continue
                    st = fam["stack"]
                    if st.producer is not None \
                            and id(st.producer) not in alive:
                        bad.append(p)
                        break
                    lo = st.producer.end if st.producer is not None else 0
                    if any(lo <= i < p.start
                           for m in fam["members"]
                           for i in outside_writes.get(m, ())):
                        bad.append(p)
                        break
            if not bad:
                break
            for p in bad:
                plans.remove(p)
                skip("outside_write")
            run_ranges = [(p.start, p.end) for p in plans]
        if not plans:
            return False

        # -- which stacked members must materialize per-layer ---------------
        # (read by a surviving unrolled op after the producing run, a
        # fetch, or a persistable write-back that no state carrier
        # covers)
        reads_after: Dict[str, int] = {}
        for i, op in enumerate(ops):
            if outside(i):
                for n in op.input_arg_names():
                    reads_after[n] = max(reads_after.get(n, -1), i)
        fetches = set(ctx.fetch_names)
        need: Dict[int, List[tuple]] = {}  # plan idx -> (stack, member, idx)
        for pi, p in enumerate(plans):
            for fam in p.ys:
                st = fam["stack"]
                for m in fam["members"]:
                    wanted = m in fetches
                    if not wanted and m in reads_after \
                            and reads_after[m] >= p.end:
                        wanted = True
                    if not wanted and st.kind == "ys":
                        var = block._find_var_recursive(m)
                        if (var is not None and var.persistable) or (
                                ctx.scope is not None
                                and ctx.scope.has_var(m)):
                            # persistable per-layer write-back with no
                            # scope-view coverage: keep the write
                            wanted = True
                    if wanted:
                        st.active = True
                        need.setdefault(pi, []).append(
                            (st, m, st.index_of[m]))
            for (t, w) in p.carries:
                for tpl_n, kind in ((t, "carry_pre"), (w, "carry_post")):
                    mem = tuple(s[tpl_n] for s in p.sigmas)
                    sts = [s for s in member_stacks.get(mem[0], [])
                           if s.kind == kind and s.members == mem]
                    if not sts:
                        continue
                    st = sts[0]
                    # the final carry-out is bound directly by CarryOut;
                    # a carry-pre's first member is the run's EXTERNAL
                    # initial value -- neither needs a stacked slice
                    excluded = {mem[-1]} if kind == "carry_post" \
                        else {mem[0]}
                    for m in mem:
                        if m in excluded:
                            continue
                        if m in fetches or reads_after.get(m, -1) >= p.end:
                            st.active = True
                            need.setdefault(pi, []).append(
                                (st, m, st.index_of[m]))

        # activated carry stacks become ys entries of their producer
        for p in plans:
            for (t, w) in p.carries:
                for tpl_n, pre, kind in ((t, True, "carry_pre"),
                                         (w, False, "carry_post")):
                    mem = tuple(s[tpl_n] for s in p.sigmas)
                    sts = [s for s in member_stacks.get(mem[0], [])
                           if s.kind == kind and s.members == mem
                           and s.active]
                    if sts and not any(f["stack"] is sts[0]
                                       for f in p.ys):
                        p.ys.append({"tpl": tpl_n, "members": mem,
                                     "pre": pre, "stack": sts[0],
                                     "flip": 0, "update_start": None})

        # -- rebuild the op stream ------------------------------------------
        from .program import Operator

        plan_at = {p.start: p for p in plans}
        new_ops: List = []
        i = 0
        n_layers_total = 0
        while i < len(ops):
            p = plan_at.get(i)
            if p is None:
                if outside(i):
                    new_ops.append(ops[i])
                i += 1
                continue
            seq = self._emit_run(block, p, policy, unroll)
            new_ops.extend(seq)
            for (st, m, j) in need.get(plans.index(p), []):
                new_ops.append(Operator(
                    block, "layer_index", {"X": [st.carrier]},
                    {"Out": [m]}, {"index": int(j)}))
            n_layers_total += p.M
            i = p.end

        block.ops[:] = new_ops
        program._bump()

        # -- scope plan + tp plan growth ------------------------------------
        used: set = set()
        for p in plans:
            for fam in p.xs:
                if fam.get("stack") is not None:
                    used.add(fam["stack"].carrier)
            for fam in p.ys:
                used.add(fam["stack"].carrier)
        state_stacks = []
        for st in registry.values():
            if st.kind != "state" or st.carrier not in used:
                continue
            tvar = block._find_var_recursive(st.template)
            state_stacks.append({
                "carrier": st.carrier,
                "members": st.members,
                "shape": tuple(int(s) for s in tvar.shape)
                if tvar is not None else (),
                "dtype": dtypes.to_str(tvar.dtype) if tvar is not None
                else "float32",
            })
        program._layer_plan = LayerScanPlan(state_stacks)

        if tp_plan is not None:
            for st in registry.values():
                if st.carrier not in used:
                    continue
                spec = tuple(tp_plan.specs.get(st.members[0], ()))
                if spec:
                    tp_plan.specs[st.carrier] = (None,) + spec
                # a pulled-out stacked allreduce replaces its members'
                # per-grad dp-reduce accounting entries
                moved = [m for m in st.members
                         if m in tp_plan.grad_reduce]
                if moved:
                    total = sum(int(tp_plan.grad_reduce.pop(m)["bytes"])
                                for m in moved)
                    tp_plan.grad_reduce[st.carrier] = {
                        "axes": ("dp",), "bytes": total}

        stat_set("pass_layer_scan_segments", len(plans))
        stat_set("pass_layer_scan_layers", n_layers_total)
        return True


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _itemsize(dtype_str: str) -> int:
    return dtypes.to_torch(dtype_str).itemsize


def _marked_inplace_cast(op, name: str) -> bool:
    return (op.type == "cast" and bool(op.attr(FUSED_ALLREDUCE_ATTR))
            and op.inputs.get("X", []) == [name]
            and op.outputs.get("Out", []) == [name])


@register_pass(before="redundant_cast_eliminate")
class FuseAllReducePass(Pass):
    """Bucketed gradient-allreduce fusion (reference
    fuse_all_reduce_op_pass + coalesce_tensor_op), the JAX package's pass
    op for op.

    Only ``c_allreduce_sum`` ops carrying ``__fused_allreduce__`` are
    touched: the transpiler stamps exactly the per-gradient collectives
    it inserted, so user-built collectives are never rewritten.  A
    gradient whose var has an unknown or dynamic shape stays unfused
    (``pass_allreduce_ops_after`` counts it).

    Safe placement: the transpiler emits each allreduce right after its
    gradient's last producer, and every consumer (optimizer, merge,
    clip) sits after the backward, so anchoring a bucket's collective at
    its last member's allreduce moves no reduction past a read of its
    input; where a layer-scanned program reads a member earlier (its
    ``layer_index`` copies of a pulled-out carrier), the bucket closes
    at that read.
    """

    name = "fuse_allreduce"

    def should_apply(self, program, ctx):
        return any(op.type == "c_allreduce_sum"
                   and op.attr(FUSED_ALLREDUCE_ATTR)
                   for op in program.global_block.ops)

    def apply(self, program, ctx):
        from ..monitor import stat_set
        from .flags import flag

        block = program.global_block
        ops = block.ops
        n_before = sum(1 for op in ops if op.type == "c_allreduce_sum")

        entries = self._collect(block, ops)
        if not entries:
            return False
        # read barrier: a bucket's reduction lands at its LAST member's
        # anchor, so a read of a member before that anchor would see the
        # pre-reduce value; each entry's first read after its own anchor
        # bounds where its bucket may still grow
        readers: Dict[str, List[int]] = {}
        for i, op in enumerate(ops):
            for n in op.input_arg_names():
                readers.setdefault(n, []).append(i)
        for e in entries:
            skip = set(e["remove"])
            e["first_read"] = next(
                (j for j in readers.get(e["grad"], ())
                 if j > e["anchor"] and j not in skip), len(ops))
        # adjacency for the overlap stretch: only bucket-member ops (the
        # marked allreduces and their cast pairs) between two entries
        member_idx = {i for e in entries for i in e["remove"]}
        for k in range(len(entries) - 1):
            lo = max(entries[k]["remove"])
            hi = min(entries[k + 1]["remove"])
            entries[k]["adj_next"] = all(
                j in member_idx for j in range(lo + 1, hi))
        entries[-1]["adj_next"] = False

        buckets = self._bucketize(
            entries, overlap=bool(flag("overlap_grad_allreduce")))
        fuse_buckets = [b for b in buckets if len(b["items"]) >= 2]
        if not fuse_buckets:
            return False

        removed: set = set()
        anchor_to_bucket: Dict[int, tuple] = {}
        for bi, b in enumerate(fuse_buckets):
            for e in b["items"]:
                removed.update(e["remove"])
            anchor = max(e["anchor"] for e in b["items"])
            anchor_to_bucket[anchor] = (bi, b)

        new_ops: List = []
        for i, op in enumerate(ops):
            if i in anchor_to_bucket:
                bi, b = anchor_to_bucket[i]
                new_ops.extend(self._emit_bucket(block, bi, b))
                continue
            if i in removed:
                continue
            new_ops.append(op)
        block.ops[:] = new_ops
        program._bump()

        n_after = sum(1 for op in new_ops if op.type == "c_allreduce_sum")
        stat_set("pass_fused_allreduce_buckets", len(fuse_buckets))
        stat_set("pass_allreduce_ops_before", n_before)
        stat_set("pass_allreduce_ops_after", n_after)
        return True

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _collect(block, ops) -> List[dict]:
        """One marked allreduce (+ its adjacent marked cast pair) per
        entry, in program order."""
        entries = []
        for i, op in enumerate(ops):
            if op.type != "c_allreduce_sum" \
                    or not op.attr(FUSED_ALLREDUCE_ATTR):
                continue
            xs = op.inputs.get("X", [])
            if len(xs) != 1 or op.outputs.get("Out", []) != xs:
                continue  # only the transpiler's in-place form fuses
            g = xs[0]
            var = block._find_var_recursive(g)
            if var is None or any(int(s) <= 0 for s in var.shape):
                continue  # unknown/dynamic shape: left unfused
            try:
                dtype = dtypes.to_str(var.dtype)
            except (KeyError, ValueError):
                continue
            remove = [i]
            anchor = i
            pre = i > 0 and _marked_inplace_cast(ops[i - 1], g)
            post = i + 1 < len(ops) and _marked_inplace_cast(ops[i + 1], g)
            if pre and post:
                remove += [i - 1, i + 1]
                anchor = i + 1
            # a layer-scan stacked gradient moves num_layers x its var's
            # declared (per-layer) shape
            stack = int(op.attr(LAYER_STACK_ATTR, 0) or 0)
            shape = tuple(int(s) for s in var.shape)
            if stack > 1:
                shape = (stack,) + shape
            entries.append({
                "stacked": stack > 1,
                "grad": g,
                "shape": shape,
                "dtype": dtype,
                "bytes": _numel(shape) * _itemsize(dtype),
                "fp16": pre and post,
                "ring_id": int(op.attr("ring_id", 0) or 0),
                "cap": float(op.attr(FUSE_SIZE_ATTR, DEFAULT_FUSE_MB))
                * 1024.0 * 1024.0,
                "anchor": anchor,
                "remove": remove,
            })
        return entries

    @staticmethod
    def _bucketize(entries, overlap=False) -> List[dict]:
        """Greedy size-capped bucketing in program order, one bucket
        stream per (dtype, ring, fp16) key.  ``overlap``
        (FLAGS_overlap_grad_allreduce): a bucket holding a stacked
        gradient carrier admits no unstacked entry past intervening
        backward compute."""
        from ..monitor import stat_add

        buckets: List[dict] = []
        open_buckets: Dict[tuple, dict] = {}
        for pos, e in enumerate(entries):
            key = (e["dtype"], e["ring_id"], e["fp16"])
            if e["bytes"] > e["cap"]:
                # an over-cap gradient gets a closed bucket of its own;
                # its neighbours keep fusing
                buckets.append({"key": key, "items": [e],
                                "bytes": e["bytes"]})
                continue
            b = open_buckets.get(key)
            if b is not None and e["anchor"] >= b["min_read"]:
                # the bucket's emission point would pass a member's
                # first read: close it at the read barrier
                open_buckets.pop(key)
                b = None
            if b is not None and overlap and b["has_stacked"] \
                    and not e.get("stacked", False) \
                    and not all(entries[j].get("adj_next", False)
                                for j in range(b["last_pos"], pos)):
                closed = open_buckets.pop(key)
                closed["overlap_hidden"] = True
                b = None
                stat_add("pass_overlap_stretched_buckets")
            if b is None or b["bytes"] + e["bytes"] > e["cap"]:
                b = {"key": key, "items": [], "bytes": 0,
                     "min_read": float("inf"), "has_stacked": False,
                     "last_pos": pos}
                open_buckets[key] = b
                buckets.append(b)
            b["items"].append(e)
            b["bytes"] += e["bytes"]
            b["has_stacked"] = b["has_stacked"] or e.get("stacked", False)
            b["last_pos"] = pos
            b["min_read"] = min(b["min_read"],
                                e.get("first_read", float("inf")))
        return buckets

    @staticmethod
    def _emit_bucket(block, bucket_idx: int, bucket: dict) -> List:
        from .program import Operator

        dtype, ring_id, fp16 = bucket["key"]
        grads = [e["grad"] for e in bucket["items"]]
        shapes = [e["shape"] for e in bucket["items"]]
        sections = [_numel(s) for s in shapes]
        # deterministic name: a re-transpile fuses to the same fingerprint
        fused = f"@FUSED_GRAD@{dtype}@r{ring_id}@{bucket_idx}"
        block.create_var(name=fused, shape=[sum(sections)], dtype=dtype,
                         stop_gradient=True)
        seq = [Operator(block, "coalesce_tensor", {"Input": grads},
                        {"FusedOutput": [fused]},
                        {"dtype": dtypes.to_enum(dtype)})]
        if fp16:
            seq.append(Operator(block, "cast", {"X": [fused]},
                                {"Out": [fused]},
                                {"out_dtype": dtypes.to_enum("bfloat16")}))
        fused_attrs = {"ring_id": ring_id, "use_calc_stream": True,
                       COMM_ID_ATTR: f"bucket:{dtype}@r{ring_id}@{bucket_idx}"}
        if bucket.get("overlap_hidden"):
            fused_attrs[COMM_OVERLAP_ATTR] = True
        seq.append(Operator(block, "c_allreduce_sum", {"X": [fused]},
                            {"Out": [fused]}, fused_attrs))
        if fp16:
            seq.append(Operator(block, "cast", {"X": [fused]},
                                {"Out": [fused]},
                                {"out_dtype": dtypes.to_enum(dtype)}))
        seq.append(Operator(
            block, "uncoalesce_tensor", {"Input": [fused]},
            {"Output": grads},
            {"sections": sections,
             "dims": [int(d) for s in shapes for d in s],
             "ranks": [len(s) for s in shapes]}))
        return seq


@register_pass
class DeadOpEliminationPass(Pass):
    """Drop ops whose outputs feed neither a fetch nor persistent state
    (reference eager deletion / graph DCE role), reusing the executor's
    ``_prune_ops`` backward slice.

    Roots: the dispatch fetch list, every persistable write, and every
    write whose name already lives in the scope chain (the same
    liveness rule ``_analyze_state`` uses for state_out), so optimizer
    updates and user-visible state always survive.  Ops with no outputs
    and the p2p/barrier side-effect ops are kept unconditionally.
    """

    name = "dead_op_eliminate"

    @staticmethod
    def _live_ops(program, ctx):
        """(kept op list, dead count) -- O(ops); cheap enough that
        ``should_apply`` runs it on the ORIGINAL program, so the common
        nothing-to-remove case never pays the pipeline's clone.
        Memoized on the ctx per (program identity, version) so the
        should_apply/apply sequence slices each program once."""
        from .executor import _prune_ops
        from .lowering import PSEUDO_OPS

        memo_key = ("dce_live", id(program), program._version)
        hit = ctx._memo.get(memo_key)
        if hit is not None:
            return hit

        block = program.global_block
        roots = set(ctx.fetch_names)
        for op in block.ops:
            for n in op.output_arg_names():
                var = block._find_var_recursive(n)
                if (var is not None and var.persistable) or (
                        ctx.scope is not None and ctx.scope.has_var(n)):
                    roots.add(n)
        if not roots:
            result = (None, 0)
        else:
            keep = _prune_ops(program, sorted(roots),
                              keep_side_effect_ops=True)
            keep_ids = {id(op) for op in keep}
            new_ops = [op for op in block.ops
                       if op.type in PSEUDO_OPS or id(op) in keep_ids]
            result = (new_ops, len(block.ops) - len(new_ops))
        ctx._memo[memo_key] = result
        return result

    def should_apply(self, program, ctx):
        return self._live_ops(program, ctx)[1] > 0

    def apply(self, program, ctx):
        from ..monitor import stat_add

        new_ops, n_removed = self._live_ops(program, ctx)
        if not n_removed:
            return False
        program.global_block.ops[:] = new_ops
        program._bump()
        stat_add("pass_dead_ops_removed", n_removed)
        return True


class PassPipeline:
    """Ordered pass application with copy-on-write semantics.

    ``apply`` runs every pass on a CLONE of the program and returns the
    clone when any pass changed it, else the original object -- the
    caller (Executor) caches the result per
    ``(program.fingerprint(), config_key, fetch, feeds, scope, flags)``.
    """

    def __init__(self, passes: Optional[Sequence[Pass]] = None):
        if passes is None:
            _ensure_external_passes()
        self._passes: Tuple[Pass, ...] = tuple(
            passes if passes is not None
            else (cls() for cls in PASS_REGISTRY.values()))

    @property
    def passes(self) -> Tuple[Pass, ...]:
        return self._passes

    def config_key(self) -> tuple:
        """Joins the Executor's pass-cache key; per-pass knobs that ride
        op attrs are already part of the program fingerprint."""
        return tuple(p.name for p in self._passes)

    def apply(self, program, ctx: Optional[PassContext] = None):
        from ..monitor import stat_add
        from ..observe import tracer as otrace

        ctx = ctx or PassContext()
        if not any(p.should_apply(program, ctx) for p in self._passes):
            return program
        work = program.clone()
        changed = False
        for p in self._passes:
            if p.should_apply(work, ctx):
                # one tracer span per pass, nested under the Executor's
                # executor/pass_pipeline span (observe/tracer.py)
                with otrace.span(f"pass/{p.name}"):
                    changed = bool(p.apply(work, ctx)) or changed
        stat_add("pass_pipeline_apply")
        return work if changed else program


_EXTERNAL_PASSES_LOADED = False


def _ensure_external_passes():
    """Import the modules that register passes from outside this file,
    so that the registry is complete before a pipeline takes its snapshot.
    Lazy (the first default pipeline, i.e. the first Executor run):
    importing slim while this module loads would cycle through the
    framework package."""
    global _EXTERNAL_PASSES_LOADED
    if _EXTERNAL_PASSES_LOADED:
        return
    _EXTERNAL_PASSES_LOADED = True
    from ..slim import quantization  # noqa: F401 -- import registers
    #                                  PostTrainingWeightQuantPass


_default_pipeline: Optional[PassPipeline] = None


def default_pipeline() -> PassPipeline:
    global _default_pipeline
    if _default_pipeline is None:
        _default_pipeline = PassPipeline()
    return _default_pipeline


def apply_passes(program, fetch_names: Sequence[str] = (),
                 feed_names: Sequence[str] = (), scope=None):
    """One-shot convenience: run the default pipeline over ``program``
    (returns the rewritten clone, or ``program`` itself when nothing
    applied)."""
    return default_pipeline().apply(
        program, PassContext(fetch_names=fetch_names,
                             feed_names=feed_names, scope=scope))
