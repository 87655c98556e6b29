"""Meta-optimizers: strategy-driven optimizer and program rewrites.

Counterpart of ``paddle_tpu/distributed/fleet/meta_optimizers.py``
(reference fleet/meta_optimizers/ and the StrategyCompiler chain,
fleet/base/strategy_compiler.py:89,112), at one process.  Each
meta-optimizer declares ``_can_apply()`` against the
``DistributedStrategy`` and wraps ``minimize``; ``compile_strategy``
orders the applicable ones as the JAX package does, and each builds the
program the JAX one builds.

At one process the port runs:
- ``LarsMetaOptimizer``, ``LambMetaOptimizer``: swap the inner Momentum /
  Adam for LARS / LAMB;
- ``GradientMergeMetaOptimizer``: the masked update with its state
  snapshot and select-restore, and the ``grad_transform`` route that fp16
  AMP takes;
- ``AMPMetaOptimizer``: bf16 by default, fp16 with dynamic loss scaling
  when ``use_bf16`` is false;
- ``RecomputeMetaOptimizer`` with ``checkpoints``, and its
  scan-over-layers stamps ``policy`` / ``scan_layers``;
- ``DGCMetaOptimizer`` (its ``dgc`` op is a one-device top-k sparsifier);
- ``FP16AllReduceMetaOptimizer``, which only stamps the program.

``GraphExecutionMetaOptimizer`` applies above one rank: it runs the
inner chain, then ``collective_transpiler.GradAllReduce`` with the
strategy's ``fuse_all_reduce_ops`` / ``fuse_grad_size_in_MB`` and the
program's ``_fp16_allreduce``, as the JAX class does.
``ShardingMetaOptimizer`` (above one rank), ``LocalSGDMetaOptimizer``,
``PipelineMetaOptimizer``, ``TensorParallelMetaOptimizer`` and
``ExpertParallelMetaOptimizer`` raise the later-slice error (ROADMAP
Queue A item 8).
"""
from __future__ import annotations

from ..parallel_env import get_world_size, later


class MetaOptimizerBase:
    can_be_last = False

    def __init__(self, inner_opt):
        self.inner_opt = inner_opt
        self.role_maker = None
        self.user_strategy = None

    def _set_basic_info(self, loss, role_maker, user_opt, user_strategy):
        self.loss = loss
        self.role_maker = role_maker
        self.user_opt = user_opt
        self.user_strategy = user_strategy

    def _can_apply(self) -> bool:
        return False

    def _nranks(self):
        return get_world_size()

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return self.inner_opt.minimize(loss, startup_program, parameter_list,
                                       no_grad_set)

    # delegation so meta-optimizers compose (a wrapping meta-opt may call
    # backward/apply_gradients on its inner chain)
    def backward(self, *args, **kwargs):
        return self.inner_opt.backward(*args, **kwargs)

    def apply_gradients(self, params_grads):
        return self.inner_opt.apply_gradients(params_grads)

    def __getattr__(self, name):
        if name == "inner_opt":  # not yet set (unpickling/deepcopy)
            raise AttributeError(name)
        return getattr(self.inner_opt, name)


class LarsMetaOptimizer(MetaOptimizerBase):
    """Swap Momentum for LARS (reference lars_optimizer.py)."""

    def _can_apply(self):
        from ...optimizer.static_opt import MomentumOptimizer

        return (self.user_strategy.lars
                and isinstance(self.inner_opt, MomentumOptimizer))

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ...optimizer.static_opt import LarsMomentumOptimizer

        cfg = self.user_strategy.lars_configs
        opt = LarsMomentumOptimizer(
            learning_rate=self.inner_opt._learning_rate,
            momentum=getattr(self.inner_opt, "_momentum", 0.9),
            lars_coeff=cfg["lars_coeff"],
            lars_weight_decay=cfg["lars_weight_decay"],
            regularization=self.inner_opt.regularization,
            grad_clip=self.inner_opt._grad_clip)
        return opt.minimize(loss, startup_program, parameter_list, no_grad_set)


class LambMetaOptimizer(MetaOptimizerBase):
    """Swap Adam for LAMB (reference lamb_optimizer.py)."""

    def _can_apply(self):
        from ...optimizer.static_opt import AdamOptimizer

        return (self.user_strategy.lamb
                and isinstance(self.inner_opt, AdamOptimizer))

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ...optimizer.static_opt import LambOptimizer

        cfg = self.user_strategy.lamb_configs
        opt = LambOptimizer(
            learning_rate=self.inner_opt._learning_rate,
            beta1=getattr(self.inner_opt, "_beta1", 0.9),
            beta2=getattr(self.inner_opt, "_beta2", 0.999),
            epsilon=getattr(self.inner_opt, "_epsilon", 1e-6),
            lamb_weight_decay=cfg["lamb_weight_decay"],
            regularization=self.inner_opt.regularization,
            grad_clip=self.inner_opt._grad_clip)
        return opt.minimize(loss, startup_program, parameter_list, no_grad_set)


class AMPMetaOptimizer(MetaOptimizerBase):
    """Mixed precision (reference amp_optimizer.py): wrap the inner
    optimizer with the static AMP decorator, which inserts bf16/fp16
    casts by the white and black lists, plus dynamic loss scaling in
    fp16 mode (amp/static_amp.py)."""

    def _can_apply(self):
        return self.user_strategy.amp

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ...amp.lists import AutoMixedPrecisionLists
        from ...amp.static_amp import decorate

        cfg = self.user_strategy.amp_configs
        lists = AutoMixedPrecisionLists(
            custom_white_list=cfg.get("custom_white_list") or None,
            custom_black_list=cfg.get("custom_black_list") or None,
            custom_black_varnames=cfg.get("custom_black_varnames") or None)
        wrapped = decorate(
            self.inner_opt,
            amp_lists=lists,
            init_loss_scaling=float(cfg.get("init_loss_scaling", 2.0 ** 15)),
            incr_every_n_steps=int(cfg.get("incr_every_n_steps", 1000)),
            decr_every_n_nan_or_inf=int(cfg.get("decr_every_n_nan_or_inf", 2)),
            incr_ratio=float(cfg.get("incr_ratio", 2.0)),
            decr_ratio=float(cfg.get("decr_ratio", 0.5)),
            use_dynamic_loss_scaling=bool(
                cfg.get("use_dynamic_loss_scaling", True)),
            use_bf16=bool(cfg.get("use_bf16", True)))
        if not wrapped._use_bf16 and not getattr(
                self.inner_opt, "supports_grad_transform", False):
            # fp16 mode drives backward/apply_gradients directly; a
            # DIRECT gradient-merge inner composes via the grad-transform
            # hook, but a merge buried deeper in the chain would be
            # silently bypassed: refuse that loudly
            o = self.inner_opt
            while isinstance(o, MetaOptimizerBase):
                if isinstance(o, GradientMergeMetaOptimizer):
                    raise NotImplementedError(
                        "amp (fp16 + loss scaling) composes with "
                        "gradient_merge only when gradient_merge is the "
                        "direct inner optimizer; use bf16 amp "
                        "(amp_configs={'use_bf16': True}, the default) "
                        "for this chain")
                o = o.inner_opt
        return wrapped.minimize(loss, startup_program, parameter_list,
                                no_grad_set)


class RecomputeMetaOptimizer(MetaOptimizerBase):
    """Activation recompute (reference recompute_optimizer.py +
    backward.py:689): the user's checkpoint vars partition the forward,
    and ``append_backward`` re-emits each segment behind
    ``recompute_barrier`` ops just before the gradient ops that read it,
    so only one segment's activations are alive in the backward.

    Scan-over-layers extras (recompute_configs ``policy`` /
    ``scan_layers``), as in the JAX package: stamped AFTER the inner
    minimize onto the program's optimizer ops (``__layer_scan__`` /
    ``__layer_scan_policy__``: attrs, so the contract survives
    clone/proto round trips and re-keys every executor cache through the
    fingerprint).  They turn the executor's LayerScanPass on for this
    program and name the remat policy its scan bodies record (the
    JAX package's ``jax.checkpoint`` policy; the port's recompute is the
    checkpoints' program-level one, so the policy changes no number)."""

    def _can_apply(self):
        return self.user_strategy.recompute

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ...framework.passes import (LAYER_SCAN_ATTR,
                                         LAYER_SCAN_POLICY_ATTR,
                                         REMAT_POLICIES)

        cfg = self.user_strategy.recompute_configs
        ckpts = list(cfg.get("checkpoints", []))
        policy = str(cfg.get("policy") or "")
        scan_layers = int(cfg.get("scan_layers") or 0)
        if policy and policy not in REMAT_POLICIES:
            raise ValueError(
                f"recompute_configs['policy'] must be one of "
                f"{sorted(REMAT_POLICIES)}, got {policy!r}")
        if not ckpts and not (policy or scan_layers):
            raise ValueError(
                "strategy.recompute=True needs recompute_configs with "
                "'checkpoints': [var_names] (barrier-based recompute), "
                "'scan_layers': N and/or 'policy': <remat policy> "
                "(scan-over-layers), or both")
        prog = loss.block.program
        if ckpts:
            prog._recompute_checkpoints = ckpts
        ret = self.inner_opt.minimize(loss, startup_program, parameter_list,
                                      no_grad_set)
        if policy or scan_layers:
            stamped = False
            for op in prog.global_block.ops:
                if op.type in _OPTIMIZER_OP_TYPES:
                    if scan_layers:
                        op.attrs[LAYER_SCAN_ATTR] = scan_layers
                    if policy:
                        op.attrs[LAYER_SCAN_POLICY_ATTR] = policy
                    stamped = True
            if not stamped:
                raise ValueError(
                    "recompute_configs scan_layers/policy found no "
                    "optimizer ops to stamp; minimize() must build the "
                    "training program first")
            prog._bump()
        return ret


# the optimizer ops a scan stamp rides (the JAX package's list)
_OPTIMIZER_OP_TYPES = {
    "sgd", "momentum", "adam", "adamw", "adamax", "adagrad", "adadelta",
    "rmsprop", "ftrl", "lamb", "lars_momentum", "dgc_momentum", "dpsgd",
}


class GradientMergeMetaOptimizer(MetaOptimizerBase):
    """Accumulate gradients K steps, apply the update on every K-th step
    (reference GradientMergeOptimizer, fluid/optimizer.py:5025).

    No conditional block: the update runs every step on a masked
    gradient, merged = acc * mask (mask 1 on the K-th step, else 0), and
    every state var the optimizer ops write is copied before them and
    select-restored after, so optimizer state advances only on update
    steps.  In the port's captured step state is updated in place; the
    ``assign`` copies (a new tensor, never an alias), so the restore reads
    the values from before the update."""

    supports_grad_transform = True  # fp16-AMP composes through the mask

    def _can_apply(self):
        return self.user_strategy.gradient_merge

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_transform=None):
        from ...framework import unique_name
        from ...framework.program import Operator, default_startup_program
        from ...initializer import ConstantInitializer

        cfg = self.user_strategy.gradient_merge_configs
        k = int(cfg.get("k_steps", 1))
        avg = bool(cfg.get("avg", True))
        if k <= 1:
            if grad_transform is None:
                return self.inner_opt.minimize(loss, startup_program,
                                               parameter_list, no_grad_set)
            # a degenerate merge still owes the caller its transform (fp16
            # AMP's unscale and overflow check ride it)
            pgs = self.inner_opt.backward(loss, startup_program,
                                          parameter_list, no_grad_set)
            pgs = grad_transform(pgs)
            return self.inner_opt.apply_gradients(pgs), pgs

        params_grads = self.inner_opt.backward(
            loss, startup_program, parameter_list, no_grad_set)
        block = loss.block.program.global_block
        startup = startup_program or default_startup_program()

        def persistent(name, shape, value):
            v = block.create_var(name=name, shape=list(shape),
                                 dtype="float32", persistable=True,
                                 stop_gradient=True)
            sv = startup.global_block.create_var(
                name=name, shape=list(shape), dtype="float32",
                persistable=True)
            ConstantInitializer(value)(sv, startup.global_block)
            return v

        step = persistent(unique_name.generate("gm_step"), [1], 0.0)
        block.append_op("increment", {"X": [step.name]},
                        {"Out": [step.name]}, {"step": 1.0})
        k_const = block.create_var(name=unique_name.generate("gm_k"),
                                   shape=[1], dtype="float32",
                                   stop_gradient=True)
        block.append_op("fill_constant", {}, {"Out": [k_const.name]},
                        {"shape": [1], "dtype": "float32", "value": float(k)})
        cond = block.create_var(name=unique_name.generate("gm_cond"),
                                shape=[1], dtype="bool", stop_gradient=True)
        block.append_op("equal", {"X": [step.name], "Y": [k_const.name]},
                        {"Out": [cond.name]})
        mask = block.create_var(name=unique_name.generate("gm_mask"),
                                shape=[1], dtype="float32",
                                stop_gradient=True)
        block.append_op("cast", {"X": [cond.name]}, {"Out": [mask.name]},
                        {"out_dtype": "float32"})
        # step wraps back to 0 on update steps: step *= (1 - mask)
        inv = block.create_var(name=unique_name.generate("gm_inv"),
                               shape=[1], dtype="float32",
                               stop_gradient=True)
        block.append_op("scale", {"X": [mask.name]}, {"Out": [inv.name]},
                        {"scale": -1.0, "bias": 1.0, "bias_after_scale": True})
        block.append_op("elementwise_mul",
                        {"X": [step.name], "Y": [inv.name]},
                        {"Out": [step.name]}, {"axis": -1})

        merged = []
        acc_names = []
        for p, g in params_grads:
            acc = persistent(unique_name.generate(p.name + "_gm_acc"),
                             p.shape, 0.0)
            acc_names.append(acc.name)
            # __gm_grad__ marks the accumulate op (an op attr, so the
            # linkage survives clone/proto round-trips)
            block.append_op("elementwise_add",
                            {"X": [acc.name], "Y": [g.name]},
                            {"Out": [acc.name]},
                            {"axis": -1, "__gm_grad__": g.name})
            mg = block.create_var(name=unique_name.generate(g.name + ".gm"),
                                  shape=list(p.shape), dtype="float32",
                                  stop_gradient=True)
            block.append_op("elementwise_mul",
                            {"X": [acc.name], "Y": [mask.name]},
                            {"Out": [mg.name]}, {"axis": -1})
            if avg:
                block.append_op("scale", {"X": [mg.name]}, {"Out": [mg.name]},
                                {"scale": 1.0 / k, "bias": 0.0,
                                 "bias_after_scale": True})
            merged.append((p, block.var(mg.name)))

        # optimizer ops run every step on the masked grad; snapshot every
        # state var they overwrite and select-restore on non-update steps.
        # The mark sits BEFORE the grad transform so state the transform
        # writes (fp16-AMP's loss-scaling counters) is snapshot and
        # restored like optimizer state.
        mark = len(block.ops)
        if grad_transform is not None:
            merged = grad_transform(merged)
        opt_ops = self.inner_opt.apply_gradients(merged)
        appended = block.ops[mark:]
        state_names = []
        seen = set()
        for op in appended:
            for n in op.output_arg_names():
                if n in seen:
                    continue
                var = block._find_var_recursive(n)
                if var is not None and var.persistable:
                    seen.add(n)
                    state_names.append(n)
        backups = {}
        insert_at = mark
        for n in state_names:
            b = n + ".gm_backup"
            var = block._find_var_recursive(n)
            block.create_var(name=b, shape=list(var.shape), dtype=var.dtype,
                             stop_gradient=True)
            bop = Operator(block, "assign", {"X": [n]}, {"Out": [b]})
            block.ops.insert(insert_at, bop)
            insert_at += 1
            backups[n] = b
        for n, b in backups.items():
            # n = mask*n_updated + (1-mask)*backup
            upd = n + ".gm_upd"
            var = block._find_var_recursive(n)
            block.create_var(name=upd, shape=list(var.shape),
                             dtype=var.dtype, stop_gradient=True)
            block.append_op("elementwise_mul", {"X": [n], "Y": [mask.name]},
                            {"Out": [upd]}, {"axis": -1})
            keep = b + ".keep"
            block.create_var(name=keep, shape=list(var.shape),
                             dtype=var.dtype, stop_gradient=True)
            block.append_op("elementwise_mul", {"X": [b], "Y": [inv.name]},
                            {"Out": [keep]}, {"axis": -1})
            block.append_op("elementwise_add", {"X": [upd], "Y": [keep]},
                            {"Out": [n]}, {"axis": -1})

        # accumulators reset after an applied update: acc *= (1 - mask)
        for acc_name in acc_names:
            block.append_op("elementwise_mul",
                            {"X": [acc_name], "Y": [inv.name]},
                            {"Out": [acc_name]}, {"axis": -1})
        loss.block.program._bump()
        return opt_ops, params_grads


class DGCMetaOptimizer(MetaOptimizerBase):
    """Deep gradient compression (reference
    fleet/meta_optimizers/dgc_optimizer.py + operators/dgc_op.cc):
    per-param momentum/residual accumulators feed a top-k sparsifying
    ``dgc`` op between backward and the optimizer apply.

    Pair with a plain SGD inner optimizer: the momentum correction lives
    inside the dgc op's U accumulator.  The sparsity ratio is constant:
    only ``dgc_configs["sparsity"][0]`` is honoured, as in the JAX
    package."""

    def _can_apply(self):
        return self.user_strategy.dgc

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ...framework import unique_name
        from ...framework.program import default_startup_program
        from ...initializer import ConstantInitializer

        cfg = self.user_strategy.dgc_configs or {}
        ratio = 1.0 - float((cfg.get("sparsity") or [0.999])[0])
        rampup_begin = float(cfg.get("rampup_begin_step", 0))
        m = 0.9  # reference DGCMomentumOptimizer default; DGCConfig
        # carries no momentum field

        params_grads = self.inner_opt.backward(
            loss, startup_program, parameter_list, no_grad_set)
        block = loss.block.program.global_block
        startup = startup_program or default_startup_program()

        def persistent(name, shape, value):
            v = block.create_var(name=name, shape=list(shape),
                                 dtype="float32", persistable=True,
                                 stop_gradient=True)
            sv = startup.global_block.create_var(
                name=name, shape=list(shape), dtype="float32",
                persistable=True)
            ConstantInitializer(value)(sv, startup.global_block)
            return v

        step = persistent(unique_name.generate("dgc_step"), [1], 0.0)
        block.append_op("increment", {"X": [step.name]},
                        {"Out": [step.name]}, {"step": 1.0})

        compressed = []
        for p, g in params_grads:
            u = persistent(unique_name.generate(p.name + "_dgc_u"),
                           p.shape, 0.0)
            v = persistent(unique_name.generate(p.name + "_dgc_v"),
                           p.shape, 0.0)
            enc = block.create_var(
                name=unique_name.generate(g.name + ".dgc"),
                shape=list(p.shape), dtype="float32", stop_gradient=True)
            block.append_op(
                "dgc",
                {"Grad": [g.name], "U": [u.name], "V": [v.name],
                 "CurrentStep": [step.name]},
                {"U_out": [u.name], "V_out": [v.name],
                 "EncodeGrad": [enc.name], "Grad_out": [enc.name]},
                {"m": m, "ratio": ratio,
                 "rampup_begin_step": rampup_begin})
            compressed.append((p, block.var(enc.name)))
        opt_ops = self.inner_opt.apply_gradients(compressed)
        loss.block.program._bump()
        return opt_ops, params_grads


class FP16AllReduceMetaOptimizer(MetaOptimizerBase):
    """Cast grads to fp16/bf16 around the allreduce
    (reference fp16_allreduce_optimizer.py).  At one rank there is no
    allreduce: it only stamps the program."""

    def _can_apply(self):
        return self.user_strategy.fp16_allreduce

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        loss.block.program._fp16_allreduce = True
        return ops, params_grads


class LocalSGDMetaOptimizer(MetaOptimizerBase):
    """Periodic parameter averaging instead of a per-step allreduce
    (reference localsgd_optimizer.py): it needs per-process parameter
    state, so it waits for several processes."""

    can_be_last = True

    def _can_apply(self):
        return self.user_strategy.localsgd

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise later("strategy.localsgd")


class PipelineMetaOptimizer(MetaOptimizerBase):
    """GPipe pipeline parallelism over a 'pp' mesh axis."""

    can_be_last = True

    def _can_apply(self):
        return self.user_strategy.pipeline

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise later("strategy.pipeline")


class ShardingMetaOptimizer(MetaOptimizerBase):
    """ZeRO-1 optimizer-state sharding over the data-parallel ranks:
    applies only above one rank."""

    can_be_last = True

    def _can_apply(self):
        return self.user_strategy.sharding and self._nranks() > 1

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise later("strategy.sharding")


class GraphExecutionMetaOptimizer(MetaOptimizerBase):
    """The collective data-parallel transpile (reference
    graph_execution_optimizer.py:92): applies only above one rank."""

    can_be_last = True

    def _can_apply(self):
        return self._nranks() > 1

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ...framework.program import GRAD_SUFFIX
        from .collective_transpiler import GradAllReduce

        ops, params_grads = self.inner_opt.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        prog = loss.block.program
        strat = self.user_strategy
        GradAllReduce(
            self._nranks(),
            fuse_all_reduce=bool(strat.fuse_all_reduce_ops)
            if strat is not None else True,
            fuse_grad_size_in_MB=(strat.fuse_grad_size_in_MB or 32)
            if strat is not None else 32,
            fp16=bool(getattr(prog, "_fp16_allreduce", False)),
        ).transpile(prog, params_grads,
                    loss_grad_name=loss.name + GRAD_SUFFIX)
        return ops, params_grads


class TensorParallelMetaOptimizer(MetaOptimizerBase):
    """Megatron-style tensor parallelism over an 'mp' mesh axis."""

    def _can_apply(self):
        return self.user_strategy.tensor_parallel

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise later("strategy.tensor_parallel")


class ExpertParallelMetaOptimizer(MetaOptimizerBase):
    """Expert parallelism over an 'ep' mesh axis."""

    def _can_apply(self):
        return self.user_strategy.expert_parallel

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise later("strategy.expert_parallel")


META_OPTIMIZERS = [
    LarsMetaOptimizer,
    LambMetaOptimizer,
    # GradientMerge innermost of the wrappers: it drives backward/apply
    # directly, so program-rewrite metas (AMP) must run outside it
    GradientMergeMetaOptimizer,
    DGCMetaOptimizer,
    AMPMetaOptimizer,
    RecomputeMetaOptimizer,
    FP16AllReduceMetaOptimizer,
    LocalSGDMetaOptimizer,
    PipelineMetaOptimizer,  # graph-level; wins over plain DP when set
    ShardingMetaOptimizer,  # graph-level; wins over plain DP when set
    GraphExecutionMetaOptimizer,
    TensorParallelMetaOptimizer,
    ExpertParallelMetaOptimizer,
]

# strategy flags neither package implements: refuse loudly rather than
# silently training without the requested behavior
_UNSUPPORTED_FLAGS = ("a_sync", "elastic", "sequence_parallel")


def compile_strategy(loss, role_maker, inner_opt, strategy):
    """Longest-compatible-chain ordering (reference strategy_compiler.py:89):
    each applicable meta-optimizer wraps the previous; graph-level ones
    (can_be_last) are mutually exclusive, the first applicable wins."""
    for flag in _UNSUPPORTED_FLAGS:
        if getattr(strategy, flag, False):
            raise NotImplementedError(
                f"DistributedStrategy.{flag} is not implemented in the "
                f"runtime of either package, and no ROADMAP item ports it; "
                f"unset it (silently ignoring it would train without the "
                f"requested behavior)")
    chain = inner_opt
    last_used = False
    applied = set()
    for cls in META_OPTIMIZERS:
        mo = cls(chain)
        mo._set_basic_info(loss, role_maker, inner_opt, strategy)
        if not mo._can_apply():
            continue
        if mo.can_be_last:
            if last_used:
                continue
            last_used = True
        applied.add(cls)
        chain = mo
    # graph-level strategies must not be silently dropped when another
    # graph-level meta-optimizer won the can_be_last slot
    graph_level = {"localsgd": LocalSGDMetaOptimizer,
                   "pipeline": PipelineMetaOptimizer,
                   "sharding": ShardingMetaOptimizer}
    winner = next((name for name, cls in graph_level.items()
                   if cls in applied), None)
    for name, cls in graph_level.items():
        if getattr(strategy, name, False) and cls not in applied:
            if winner is not None:
                reason = (f"it conflicts with strategy.{winner} (both are "
                          f"graph-level; only one can transpile the program)")
            else:
                reason = ("it needs a data-parallel degree > 1 (several "
                          "ranks: ROADMAP Queue A item 8)")
            raise ValueError(
                f"strategy.{name}=True could not be applied: {reason}")
    return chain


def chain_names(opt):
    """The class names of a compiled chain, outermost first."""
    out = [type(opt).__name__]
    while "inner_opt" in vars(opt):
        opt = vars(opt)["inner_opt"]
        out.append(type(opt).__name__)
    return out
