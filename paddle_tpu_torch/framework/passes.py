"""Program-IR optimization pass pipeline.

Counterpart of ``paddle_tpu/framework/passes.py`` (role parity:
reference build-strategy graph passes, framework/ir/pass.h).  Passes are
*program rewrites applied before lowering*: the Executor clones the
program, runs the pipeline on the clone, and runs the rewritten clone, so
the user's program object is never mutated (with ``FLAGS_fuse_passes=0``
the exact pre-pass program runs).  Application is cached by the Executor
per ``(program.fingerprint(), pass config, fetch/feed names, scope, the
flags the passes read)``.

Passes in default order (the JAX package's registry order; the four it
also registers and the port does not have yet keep their places in the
comments below and in ROADMAP.md):

1. ``FlashAttentionPass`` -- rewrites the unfused attention chain
   matmul(Q.K^T, alpha) -> [elementwise_add mask] -> softmax -> matmul(.V)
   and its generic grad chain into ``flash_attention`` /
   ``flash_attention_grad`` (``ops/flash_attention.py``: the forward
   kernel keeps only the per-row logsumexp, the two backward kernels
   recompute the probabilities tile by tile).
2. ``RedundantCastEliminationPass`` -- removes ``cast`` ops whose input
   provably already holds the target dtype (a conservative forward
   dataflow; unknown dtypes are never touched).
3. ``DeadOpEliminationPass`` -- drops ops that feed neither a fetch nor
   persistent/scope-resident state, reusing the executor's ``_prune_ops``
   backward slice (side-effect ops are always kept).

Observability (``paddle_tpu_torch.monitor``):
``pass_flash_attention_fused`` / ``pass_flash_attention_grad_fused``,
``pass_casts_removed``, ``pass_dead_ops_removed``,
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

# The JAX package's registry holds four more passes, not ported yet, at
# these places in the order (flash_attention_fuse comes first there too):
#   sharding_propagation, post_training_weight_quant, layer_scan,
#   fuse_allreduce
# all between flash_attention_fuse and redundant_cast_eliminate.


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
