"""A trainer of the port run at two ranks by ``tests/test_torch_multiprocess.py``.

The port's counterpart of ``tests/dist_trainer.py``: started by the port's
launcher (``paddle_tpu_torch.distributed.launch.start_local_trainers``)
with the fleet env contract and ``PADDLE_DISTRI_BACKEND=gloo`` set, on the
CPU.  It imports no JAX.  One run does every check the test reads, and
writes one JSON per rank to ``<out>-<rank>.json``:

- ``oracle``: ``build_model`` (the JAX oracle's network, written against
  the port) through ``fleet`` on this rank's shard of ``make_batch()``, 5
  steps: the fetched losses (the cross-rank mean) and the first step's
  batched ``pred`` fetch (all-gathered on dim 0);
- ``bert``: a 2-layer, hidden-64 BERT pretrain from the startup values in
  ``<init>.npz``, 3 steps on this rank's half of the global batch, with
  ``fuse_all_reduce_ops`` on and off: the losses and a digest of every
  parameter's bytes after the last step;
- ``rules``: each ``c_*`` lowering on this rank's ``rule_input(rank)``;
- ``role``: the role maker's all-gather and ``fleet.barrier_worker``;
- ``dropout``: the mask of a dropout program (all-gathered) and the
  startup's parameter sums;
- ``dygraph``: ``DataParallel`` over a linear model with manual SGD, the
  full-batch loss each step (``distributed.all_reduce`` of the local
  losses, over the number of ranks).
"""
import hashlib
import json
import os
import sys

import numpy as np

B, S, V, P = 4, 16, 64, 3          # the global batch; each rank takes half
BERT_CFG = dict(seq_len=S, vocab_size=V, hidden=64, n_layers=2, n_heads=2,
                ffn_size=128, dropout_prob=0.0, lr=1e-3,
                max_preds_per_seq=P)
RULE_OPS = (("c_allreduce_max", {}), ("c_allreduce_min", {}),
            ("c_allreduce_prod", {}), ("c_broadcast", {"root": 1}),
            ("c_allgather", {}), ("c_reducescatter", {}),
            ("c_reduce_sum", {"root_id": 1}), ("c_reduce_max", {"root_id": 0}),
            ("c_scatter", {"root": 0}), ("c_concat", {}), ("c_split", {}))


def build_model(pt, use_fleet, strategy=None):
    """``tests/dist_trainer.build_model`` in the port."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework.program import Program, program_guard
    from paddle_tpu_torch.initializer import ConstantInitializer
    from paddle_tpu_torch.optimizer import MomentumOptimizer
    from paddle_tpu_torch.param_attr import ParamAttr

    main_p, startup = Program(), Program()
    main_p.random_seed = 1
    with program_guard(main_p, startup):
        x = layers.data("x", [8])
        y = layers.data("y", [1])
        h = layers.fc(x, 16, act="relu", param_attr=ParamAttr(
            initializer=ConstantInitializer(0.1)), bias_attr=False)
        pred = layers.fc(h, 1, param_attr=ParamAttr(
            initializer=ConstantInitializer(0.2)), bias_attr=False)
        loss = layers.mean(layers.square_error_cost(pred, y))
        opt = MomentumOptimizer(0.05, 0.9)
        if use_fleet:
            from paddle_tpu_torch.distributed import fleet

            fleet.init(is_collective=True, strategy=strategy)
            fleet.distributed_optimizer(opt)
            fleet.minimize(loss)
        else:
            opt.minimize(loss)
    return main_p, startup, loss, pred


def make_batch():
    rs = np.random.RandomState(0)
    return rs.randn(32, 8).astype("f4"), rs.randn(32, 1).astype("f4")


def bert_program(p, strategy=None):
    """The small BERT pretrain at ``batch`` examples (``p``: either
    package), minimized through fleet when ``strategy`` is given."""
    from importlib import import_module

    unique = import_module(p.__name__ + ".framework.unique_name")
    prog = import_module(p.__name__ + ".framework.program")
    build = import_module(p.__name__ + ".text").bert_base_pretrain_program
    batch = B if strategy is None else B // 2
    with unique.guard():
        main, startup, _f, loss, opt = build(batch_size=batch, **BERT_CFG)
        main.random_seed = 1
        with prog.program_guard(main, startup):
            if strategy is None:
                opt.minimize(loss)
            else:
                fleet = import_module(p.__name__ + ".distributed.fleet")
                fleet.init(is_collective=True, strategy=strategy)
                fleet.distributed_optimizer(opt)
                fleet.minimize(loss)
    return main, startup, loss


def bert_feeds(steps=3):
    """One global batch a step."""
    out = []
    for seed in range(steps):
        rs = np.random.RandomState(seed)
        ids = rs.randint(0, V, (B, S)).astype("int64")
        pos = np.stack([rs.choice(S, P, replace=False) for _ in range(B)])
        mask = np.zeros((B, 1, 1, S), "float32")
        mask[1, 0, 0, -1] = -1e4
        out.append({"input_ids": ids,
                    "token_type_ids": (rs.rand(B, S) < 0.5).astype("int64"),
                    "pos_ids": np.tile(np.arange(S, dtype="int64"), (B, 1)),
                    "input_mask": mask, "pos": pos,
                    "nsp_labels": rs.randint(0, 2, (B, 1)).astype("int64")})
    return out


def bert_shard(feed, lo, hi):
    """Examples ``lo:hi`` of a global batch as the program's feeds (the
    flat masked positions are local to the shard)."""
    n = hi - lo
    ids = feed["input_ids"][lo:hi]
    flat = (np.arange(n)[:, None] * S + feed["pos"][lo:hi]).reshape(-1)
    return {"input_ids": ids, "token_type_ids": feed["token_type_ids"][lo:hi],
            "pos_ids": feed["pos_ids"][lo:hi],
            "input_mask": feed["input_mask"][lo:hi],
            "masked_flat_pos": flat.astype("int64"),
            "masked_labels": ids.reshape(-1)[flat].reshape(-1, 1),
            "masked_weights": np.ones((n * P, 1), "float32"),
            "nsp_labels": feed["nsp_labels"][lo:hi]}


def rule_input(rank):
    return (np.arange(24, dtype="f4").reshape(4, 6) / 7.0 - 1.0) \
        * (1.5 if rank else -0.5) + rank


def _digest(scope, names):
    h = hashlib.sha256()
    for n in sorted(names):
        h.update(np.ascontiguousarray(
            scope.get_var(n).detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def run_oracle(pt, rank, nranks):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy

    main, startup, loss, pred = build_model(pt, True, DistributedStrategy())
    X, Y = make_batch()
    per = len(X) // nranks
    feed = {"x": X[rank * per:(rank + 1) * per],
            "y": Y[rank * per:(rank + 1) * per]}
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    losses, preds = [], None
    for _ in range(5):
        lv, pv = exe.run(main, feed=feed, fetch_list=[loss, pred],
                         scope=scope)
        losses.append(float(np.asarray(lv).ravel()[0]))
        if preds is None:
            preds = np.asarray(pv).tolist()
    n_scale = sum(op.type == "scale" and op.attr("__dp_loss_scale__")
                  for op in main.global_block.ops)
    n_allreduce = sum(op.type == "c_allreduce_sum"
                      for op in main.global_block.ops)
    return {"losses": losses, "pred": preds, "scale_ops": int(n_scale),
            "allreduce_ops": n_allreduce}


def run_bert(pt, rank, init_path):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.monitor import stat_get

    init = dict(np.load(init_path))
    half = B // 2
    out = {}
    for fuse in (True, False):
        strategy = DistributedStrategy()
        strategy.fuse_all_reduce_ops = fuse
        main, startup, loss = bert_program(pt, strategy)
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.framework.Scope()
        exe.run(startup, scope=scope)
        for n, v in init.items():
            scope.set_var(n, v)
        losses = []
        for feed in bert_feeds():
            shard = bert_shard(feed, rank * half, (rank + 1) * half)
            losses.append(float(np.asarray(exe.run(
                main, feed=shard, fetch_list=[loss],
                scope=scope)[0]).ravel()[0]))
        params = [v.name for v in main.global_block.vars.values()
                  if getattr(v, "is_parameter", False)]
        out["fuse" if fuse else "nofuse"] = {
            "losses": losses, "digest": _digest(scope, params),
            "buckets": stat_get("pass_fused_allreduce_buckets")
            if fuse else 0}
    return out


def run_rules(pt, rank):
    import torch

    from paddle_tpu_torch.framework.lowering import (LoweringContext,
                                                     get_lowering)
    from paddle_tpu_torch.framework.program import Program

    main = Program()
    block = main.global_block
    block.create_var(name="x", shape=[4, 6], dtype="float32")
    env = {"x": torch.from_numpy(rule_input(rank))}
    ctx = LoweringContext(block, env, torch.device("cpu"))
    out = {}
    for t, attrs in RULE_OPS:
        block.create_var(name=t + "_out", shape=[4, 6], dtype="float32")
        op = block.append_op(t, {"X": ["x"]}, {"Out": [t + "_out"]},
                             dict(attrs, ring_id=0))
        get_lowering(t)(ctx, op)
        out[t] = env[t + "_out"].numpy().tolist()
    out["input_unchanged"] = bool(np.array_equal(env["x"].numpy(),
                                                 rule_input(rank)))
    return out


def run_role(pt, rank):
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True)
    rm = fleet._fleet_singleton._role_maker
    gathered = rm._all_gather({"rank": rank})
    fleet.barrier_worker()
    distributed.barrier()
    return {"gathered": gathered, "worker_num": fleet.worker_num(),
            "worker_index": fleet.worker_index()}


def run_dropout(pt, rank):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework.program import Program, program_guard
    from paddle_tpu_torch.framework import unique_name

    with unique_name.guard():
        main, startup = Program(), Program()
        main.random_seed = 3
        with program_guard(main, startup):
            x = layers.data("x", [64, 64], append_batch_size=False)
            h = layers.fc(x, 64)
            d = layers.dropout(h, 0.5)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    sums = {v.name: float(scope.get_var(v.name).double().sum())
            for v in main.global_block.vars.values()
            if getattr(v, "is_parameter", False)}
    mask_name = next(op.outputs["Mask"][0] for op in main.global_block.ops
                     if op.type == "dropout")
    mask = np.asarray(exe.run(main, feed={"x": np.ones((64, 64), "f4")},
                              fetch_list=[d, mask_name], scope=scope)[1])
    return {"param_sums": sums, "mask_shape": list(mask.shape),
            "mask_halves_equal": bool(np.array_equal(mask[:64], mask[64:])),
            "keep_share": float(mask.mean())}


def run_dygraph(pt, rank, nranks):
    import torch

    from paddle_tpu_torch import distributed

    pt.set_device("cpu")
    net = pt.nn.Linear(8, 1, bias_attr=False)
    with torch.no_grad():
        net.weight._value.copy_(torch.full((8, 1), 0.1))
    model = distributed.DataParallel(net)
    X, Y = make_batch()
    per = len(X) // nranks
    xl = pt.to_tensor(X[rank * per:(rank + 1) * per])
    yl = pt.to_tensor(Y[rank * per:(rank + 1) * per])
    losses = []
    for _ in range(5):
        diff = model(xl) - yl
        loss = pt.mean(diff * diff)
        model.scale_loss(loss).backward()
        model.apply_collective_grads()
        with torch.no_grad():
            w = net.weight._value
            w -= 0.05 * w.grad
            w.grad = None
        full = pt.to_tensor(np.asarray(loss.numpy()).reshape(1))
        distributed.all_reduce(full)
        losses.append(float(full.numpy().ravel()[0]) / nranks)
    return {"losses": losses}


def main():
    import torch

    torch.set_num_threads(1)    # CPU sums in one order: bit-equal runs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import parallel_env

    out_path, init_path = sys.argv[1], sys.argv[2]
    parallel_env.init_parallel_env()
    rank, nranks = parallel_env.get_rank(), parallel_env.get_world_size()
    result = {"rank": rank, "nranks": nranks,
              "backend": parallel_env.backend(),
              "oracle": run_oracle(pt, rank, nranks),
              "bert": run_bert(pt, rank, init_path),
              "rules": run_rules(pt, rank),
              "role": run_role(pt, rank),
              "dropout": run_dropout(pt, rank),
              "dygraph": run_dygraph(pt, rank, nranks)}
    from paddle_tpu_torch.monitor import stat_get

    result["eager_host_collective"] = stat_get(
        "executor_eager_host_collective")
    result["comm_calls"] = stat_get("comm_calls")
    with open(f"{out_path}-{rank}.json", "w") as f:
        json.dump(result, f)
    parallel_env.destroy_parallel_env()


if __name__ == "__main__":
    main()
