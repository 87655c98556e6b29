"""Collective program transpile: insert the gradient allreduce.

Counterpart of ``paddle_tpu/distributed/fleet/collective_transpiler.py``
(reference python/paddle/fluid/transpiler/collective.py): ``GradAllReduce``
(:244) scales the loss gradient by 1/nranks once, right after the
``fill_constant`` that seeds it (``_insert_scale_loss_grad_ops``), and
inserts one in-place ``c_allreduce_sum`` after each parameter gradient's
last writer.  The rewrite is the JAX package's op for op: with
``fp16`` each allreduce sits between two bfloat16 ``cast``s, and with
``fuse_all_reduce`` the inserted ops carry the ``FUSED_ALLREDUCE_ATTR`` /
``FUSE_SIZE_ATTR`` marks that ``framework/passes.py`` ``FuseAllReducePass``
buckets at dispatch.  No communicator-init ops are inserted: the process
group exists (``parallel_env.init_parallel_env``), and the ops call it
(``ops/collective.py``).  ``LocalSGD`` (:270) waits for a later slice.
"""
from __future__ import annotations

from ...framework.program import GRAD_SUFFIX, Program


def _grad_param_pairs(block, params_grads=None):
    if params_grads:
        return [(p.name if hasattr(p, "name") else p,
                 g.name if hasattr(g, "name") else g) for p, g in params_grads]
    pairs = []
    for var in block.vars.values():
        if getattr(var, "is_parameter", False):
            gname = var.name + GRAD_SUFFIX
            if block._find_var_recursive(gname) is not None:
                pairs.append((var.name, gname))
    return pairs


def _last_writer_map(ops):
    """name -> index of the LAST op writing it (``c_allreduce_sum``
    writers excluded: an in-place allreduce is not a new definition).
    One pass over the op list."""
    last = {}
    for i, op in enumerate(ops):
        if op.type == "c_allreduce_sum":
            continue
        for n in op.output_arg_names():
            last[n] = i
    return last


class GradAllReduce:
    def __init__(self, nranks, ring_id=0, fuse_all_reduce=True, fp16=False,
                 fuse_grad_size_in_MB=32):
        self.nranks = nranks
        self.ring_id = ring_id
        # fp16_allreduce: the gradients cross the group in bfloat16
        self.fp16 = fp16
        # tensor fusion: the inserted collectives are marked, and
        # FuseAllReducePass buckets them; unmarked, each runs alone
        self.fuse_all_reduce = bool(fuse_all_reduce)
        self.fuse_grad_size_in_MB = float(fuse_grad_size_in_MB or 32)

    def transpile(self, main_program: Program, params_grads=None,
                  loss_grad_name=None):
        if self.nranks <= 1:
            return main_program
        from ...framework import dtypes
        from ...framework.passes import (DP_LOSS_SCALE_ATTR, FUSE_SIZE_ATTR,
                                         FUSED_ALLREDUCE_ATTR)
        from ...framework.program import Operator

        block = main_program.global_block
        pairs = _grad_param_pairs(block, params_grads)
        grad_names = {g for _, g in pairs}
        last_writer = _last_writer_map(block.ops)
        mark = {}
        if self.fuse_all_reduce:
            mark = {FUSED_ALLREDUCE_ATTR: True,
                    FUSE_SIZE_ATTR: self.fuse_grad_size_in_MB}

        new_ops = []
        for i, op in enumerate(block.ops):
            new_ops.append(op)
            # scale the loss gradient once, before anything reads it
            if loss_grad_name and loss_grad_name in op.output_arg_names() \
                    and op.type == "fill_constant":
                new_ops.append(Operator(
                    block, "scale", {"X": [loss_grad_name]},
                    {"Out": [loss_grad_name]},
                    {"scale": 1.0 / self.nranks, "bias": 0.0,
                     "bias_after_scale": True,
                     DP_LOSS_SCALE_ATTR: True}))
            # allreduce each gradient right after its last writer
            for g in op.output_arg_names():
                if g not in grad_names or last_writer.get(g) != i:
                    continue
                if self.fp16:
                    new_ops.append(Operator(
                        block, "cast", {"X": [g]}, {"Out": [g]},
                        {"out_dtype": dtypes.to_enum("bfloat16"), **mark}))
                new_ops.append(Operator(
                    block, "c_allreduce_sum", {"X": [g]}, {"Out": [g]},
                    {"ring_id": self.ring_id, "use_calc_stream": True,
                     **mark}))
                if self.fp16:
                    new_ops.append(Operator(
                        block, "cast", {"X": [g]}, {"Out": [g]},
                        {"out_dtype": dtypes.to_enum("float32"), **mark}))
        block.ops[:] = new_ops
        main_program._bump()  # ops[] rewritten: a new fingerprint
        return main_program
