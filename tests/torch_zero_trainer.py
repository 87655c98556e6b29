"""A trainer of the port that ``tests/test_torch_multiprocess_zero.py``
runs at two ranks.

Started by the port's launcher with the fleet env contract and
``PADDLE_DISTRI_BACKEND=gloo`` on the CPU; it imports no JAX.  One run
does every check the test reads and writes ``<out>-<rank>.json`` (and,
for the checkpoint, ``<out>-<rank>-blocks.npz``):

- ``zero``: ``torch_dist_trainer.build_model`` through ``fleet`` with
  ``strategy.sharding`` on this rank's shard of ``make_batch()``, 5
  steps: the fetched losses, the shape this rank holds of each sharded
  accumulator against its declared one, and a fetch of one of them
  (all-gathered, as any batched dp-varying fetch);
- ``bert``: the small BERT pretrain from ``<init>.npz`` 3 steps with
  ZeRO-1 and with ``GradAllReduce``: losses and parameter digests;
- ``localsgd``: ``build_model`` with ``strategy.localsgd`` at
  ``k_steps`` 2, 4 steps: this rank's losses, each parameter before and
  after every average, the main program's ``capture_reason`` and the
  eager host-collective runs (the averages alone);
- ``ckpt``: ``build_model`` with ZeRO-1, 3 steps, ``save_sharded`` from
  both ranks into ``<out>-ckpt``, then step 4: its loss and this rank's
  blocks of the velocities after step 3;
- ``refusal``: ``strategy.localsgd`` when the environment says one
  process holds both ranks.
"""
import hashlib
import json
import os
import sys

import numpy as np

import torch_dist_trainer as W

LOCALSGD_K, LOCALSGD_STEPS = 2, 4
CKPT_STEPS = 3


def _strategy(**on):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy

    s = DistributedStrategy()
    for k, v in on.items():
        setattr(s, k, v)
    return s


def model(pt, **on):
    """``build_model`` through fleet with the strategy flags ``on``, under
    a fresh name guard (the one-process restore builds the same names)."""
    from paddle_tpu_torch.framework import unique_name

    with unique_name.guard():
        return W.build_model(pt, True, _strategy(**on))


def rank_feed(rank, nranks):
    X, Y = W.make_batch()
    per = len(X) // nranks
    return {"x": X[rank * per:(rank + 1) * per],
            "y": Y[rank * per:(rank + 1) * per]}


def _loss(exe, main, feed, loss, scope, extra=()):
    out = exe.run(main, feed=feed, fetch_list=[loss, *extra], scope=scope)
    return float(np.asarray(out[0]).ravel()[0]), out[1:]


def _digest(scope, names):
    h = hashlib.sha256()
    for n in sorted(names):
        h.update(np.ascontiguousarray(
            scope.get_var(n).detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def run_zero(pt, rank, nranks):
    from paddle_tpu_torch.framework.executor import zero_accumulators

    main, startup, loss, _ = model(pt, sharding=True)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    accs = zero_accumulators(main)
    feed = rank_feed(rank, nranks)
    losses = [_loss(exe, main, feed, loss, scope)[0] for _ in range(4)]
    last, fetched = _loss(exe, main, feed, loss, scope, extra=accs[:1])
    losses.append(last)
    block = main.global_block
    return {"losses": losses,
            "held": {n: list(scope.get_var(n).shape) for n in accs},
            "declared": {n: list(block.var(n).shape) for n in accs},
            "blocks": {n: scope.zero_blocks[n][1][0] for n in accs},
            "fetched_acc": np.asarray(fetched[0]).tolist(),
            "local_acc": scope.get_var(accs[0]).numpy().tolist(),
            "ops": [op.type for op in main.global_block.ops]}


def run_bert(pt, rank, init_path):
    init = dict(np.load(init_path))
    half = W.B // 2
    out = {}
    for name, on in (("zero", {"sharding": True}), ("allreduce", {})):
        main, startup, loss = W.bert_program(pt, _strategy(**on))
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.framework.Scope()
        exe.run(startup, scope=scope)
        for n, v in init.items():
            scope.set_var(n, v)
        losses = [_loss(exe, main, W.bert_shard(f, rank * half,
                                                (rank + 1) * half),
                        loss, scope)[0] for f in W.bert_feeds()]
        params = [v.name for v in main.global_block.vars.values()
                  if getattr(v, "is_parameter", False)]
        out[name] = {"losses": losses, "digest": _digest(scope, params)}
    return out


def run_localsgd(pt, rank, nranks):
    from paddle_tpu_torch.framework.executor import capture_reason
    from paddle_tpu_torch.monitor import stat_get

    main, startup, loss, _ = model(pt, localsgd=True,
                                   localsgd_configs={"k_steps": LOCALSGD_K})
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    avg = main._localsgd
    params = sorted(avg._param_names)
    seen = []
    real = avg.average_step

    def step(exe_, scope=None):
        before = {n: scope.get_var(n).numpy().tolist() for n in params}
        did = real(exe_, scope=scope)
        seen.append({"averaged": did, "before": before,
                     "after": {n: scope.get_var(n).numpy().tolist()
                               for n in params}})
        return did

    avg.average_step = step
    feed = rank_feed(rank, nranks)
    eager0 = stat_get("executor_eager_host_collective")
    losses = [_loss(exe, main, feed, loss, scope)[0]
              for _ in range(LOCALSGD_STEPS)]
    return {"losses": losses, "steps": seen,
            "capture_reason": capture_reason(main),
            "eager_host_collective": stat_get(
                "executor_eager_host_collective") - eager0,
            "ops": [op.type for op in main.global_block.ops],
            "avg_ops": [op.type for op in avg._avg_program.global_block.ops]}


def run_ckpt(pt, rank, nranks, out_path):
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.framework.executor import zero_accumulators

    main, startup, loss, _ = model(pt, sharding=True)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    feed = rank_feed(rank, nranks)
    for _ in range(CKPT_STEPS):
        _loss(exe, main, feed, loss, scope)
    accs = zero_accumulators(main)
    np.savez(f"{out_path}-{rank}-blocks.npz",
             **{n: scope.get_var(n).numpy() for n in accs})
    saved = dckpt.save_sharded(scope, out_path + "-ckpt", step=CKPT_STEPS)
    step4, _ = _loss(exe, main, feed, loss, scope)
    return {"saved": saved, "step4_loss": step4,
            "files": sorted(os.listdir(os.path.join(
                out_path + "-ckpt", f"step_{CKPT_STEPS}")))}


def run_refusal(pt):
    saved = os.environ["PADDLE_TRAINERS_NUM"]
    os.environ["PADDLE_TRAINERS_NUM"] = "1"
    try:
        model(pt, localsgd=True, localsgd_configs={"k_steps": 2})
    except NotImplementedError as e:
        return str(e)
    finally:
        os.environ["PADDLE_TRAINERS_NUM"] = saved
    return None


def main():
    import torch

    torch.set_num_threads(1)    # CPU sums in one order: bit-equal runs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import parallel_env

    out_path, init_path = sys.argv[1], sys.argv[2]
    parallel_env.init_parallel_env()
    rank, nranks = parallel_env.get_rank(), parallel_env.get_world_size()
    result = {"rank": rank, "nranks": nranks,
              "zero": run_zero(pt, rank, nranks),
              "bert": run_bert(pt, rank, init_path),
              "localsgd": run_localsgd(pt, rank, nranks),
              "ckpt": run_ckpt(pt, rank, nranks, out_path),
              "refusal": run_refusal(pt)}
    with open(f"{out_path}-{rank}.json", "w") as f:
        json.dump(result, f)
    parallel_env.destroy_parallel_env()


if __name__ == "__main__":
    main()
