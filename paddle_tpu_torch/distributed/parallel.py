"""Dygraph ``DataParallel`` and ``spawn``.

Counterpart of ``paddle_tpu/distributed/parallel.py`` (reference
python/paddle/fluid/dygraph/parallel.py: ``DataParallel``:335,
``scale_loss``:432, ``apply_collective_grads``:441; distributed/spawn.py:231).
Above one rank (a live process group, ``init_parallel_env``),
``scale_loss`` divides the loss by the number of ranks and
``apply_collective_grads`` all-reduces every parameter's gradient over
the group, in flat buckets of up to ``comm_buffer_size`` MB a dtype (the
reference's coalesced allreduce; the JAX package all-gathers each
gradient and sums, the same sums); at world size 1 the loss is returned
as it is and there is nothing to sum.  The wrapper delegates
``parameters``, ``named_parameters``, ``state_dict`` and
``set_state_dict`` to the wrapped layer, so the keys are the wrapped
layer's own, as in the JAX package.  ``spawn`` with ``nprocs > 1``
starts one rank process a device.
"""
from __future__ import annotations

import os
import pickle
import shutil
import socket
import sys
import tempfile
import time

from ..dygraph.layers import Layer
from .parallel_env import (ParallelEnv, destroy_parallel_env, get_world_size,
                           init_parallel_env)


def prepare_context(strategy=None):
    init_parallel_env()
    return ParallelEnv()


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1):
        super().__init__()
        self._layers = layers
        self._nranks = max(get_world_size(), ParallelEnv().world_size)
        self._bucket_bytes = int(comm_buffer_size) * 1024 * 1024
        if self._nranks > 1 and get_world_size() != self._nranks:
            raise RuntimeError(
                f"DataParallel over {self._nranks} processes needs the "
                f"process group: call distributed.init_parallel_env() "
                f"first")

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        if self._nranks <= 1:
            return loss
        from ..tensor.math import scale

        return scale(loss, 1.0 / self._nranks)

    def apply_collective_grads(self):
        """Sum every parameter's gradient over the ranks, in place."""
        if self._nranks <= 1:
            return None
        import torch
        import torch.distributed as dist

        from ..ops.collective import _all_reduce

        def reduce(grads):
            summed = _all_reduce(dist, torch.cat([g.reshape(-1)
                                                  for g in grads]), "sum")
            off = 0
            with torch.no_grad():
                for g in grads:
                    g.copy_(summed[off:off + g.numel()].view_as(g))
                    off += g.numel()

        buckets, sizes = {}, {}
        for p in self._layers.parameters():
            g = p._value.grad
            if g is None:
                continue
            key = (g.dtype, g.device)
            n = g.numel() * g.element_size()
            if sizes.get(key, 0) and sizes[key] + n > self._bucket_bytes:
                reduce(buckets.pop(key))
                sizes[key] = 0
            buckets.setdefault(key, []).append(g)
            sizes[key] = sizes.get(key, 0) + n
        for grads in buckets.values():
            reduce(grads)
        return None

    # delegation so DataParallel looks like the wrapped layer
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, *a, **kw):
        return self._layers.set_state_dict(*a, **kw)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Reference distributed/spawn.py: one process per device.

    The JAX package runs ``func`` once, in this process, because one TPU
    process drives every local chip.  In the port one process drives one
    device, so ``nprocs > 1`` starts ``nprocs`` rank processes (the
    ``spawn`` start method: never ``fork`` under CUDA), each with the
    launcher's env contract (``launch.start_local_trainers``); each runs
    ``init_parallel_env()`` and then ``func(*args)``.  Rank ``i`` takes
    card ``i`` over NCCL when the machine has ``nprocs`` cards; with
    fewer, every rank shares card 0 (or the CPU) over gloo, and
    ``PADDLE_DISTRI_BACKEND=nccl`` raises.  ``func`` and ``args`` must
    pickle (a module-level function).

    Returns rank 0's result once every rank has exited 0.  A rank that
    fails stops the others, and ``spawn`` raises with that rank, its exit
    code and the tail of its log (each rank's stdout and stderr go to a
    log of its own, copied to this process's stderr when all succeed).
    ``join``, ``daemon`` and ``options`` are accepted and ignored, as in
    the JAX package.  ``nprocs <= 1`` runs ``func`` here."""
    n = -1 if nprocs is None else int(nprocs)
    if n <= 1:
        init_parallel_env()
        return func(*args)
    return _spawn_ranks(func, tuple(args), n)


def _spawn_ranks(func, args, nprocs):
    import multiprocessing
    import multiprocessing.connection

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = os.environ.get("PADDLE_DISTRI_BACKEND") or (
        "nccl" if cards >= nprocs else "gloo")
    if backend == "nccl" and cards < nprocs:
        raise ValueError(
            f"spawn(nprocs={nprocs}) over NCCL needs {nprocs} cards and "
            f"this machine has {cards}: NCCL refuses two ranks on one "
            f"card; set PADDLE_DISTRI_BACKEND=gloo to run the ranks on "
            f"card 0 (or the CPU) over gloo")
    gpus = list(range(nprocs)) if cards >= nprocs else [0] * nprocs
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    tmp = tempfile.mkdtemp(prefix="paddle_spawn_")
    ctx = multiprocessing.get_context("spawn")
    procs = []
    try:
        for rank in range(nprocs):
            env = {"PADDLE_TRAINER_ID": str(rank),
                   "PADDLE_TRAINERS_NUM": str(nprocs),
                   "PADDLE_COORDINATOR": coord,
                   "PADDLE_TRAINER_ENDPOINTS": coord,
                   "FLAGS_selected_gpus": str(gpus[rank]),
                   "PADDLE_DISTRI_BACKEND": backend}
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:   # a spawned child copies the environment at its start
                p = ctx.Process(target=_spawn_rank,
                                args=(func, args, rank, tmp),
                                name=f"spawn-rank-{rank}")
                p.start()
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            procs.append(p)
        running, exited = list(procs), {}
        while running:
            for sentinel in multiprocessing.connection.wait(
                    [p.sentinel for p in running]):
                p = next(q for q in running if q.sentinel == sentinel)
                p.join()
                running.remove(p)
                exited[procs.index(p)] = time.time()
            if any(p.exitcode != 0 for p in procs if not p.is_alive()):
                # the peers of a failed rank fail on the collective it
                # left: let them end (a few seconds at most), then name
                # the rank that failed first for a reason of its own
                deadline = time.monotonic() + 5
                for p in running:
                    p.join(max(deadline - time.monotonic(), 0.1))
                    if not p.is_alive():
                        exited[procs.index(p)] = time.time()
                _stop(procs)
                rank = _first_failure(tmp, procs, exited)
                others = {r: p.exitcode for r, p in enumerate(procs)
                          if r != rank}
                raise RuntimeError(
                    f"spawn(nprocs={nprocs}): rank {rank} failed (exit "
                    f"code {procs[rank].exitcode}); the other ranks were "
                    f"stopped (exit codes {others}). Its log ends:\n"
                    f"{_log(tmp, rank)[-4000:]}")
        for rank in range(nprocs):
            text = _log(tmp, rank)
            if text:
                sys.stderr.write(f"----- spawn rank {rank} -----\n{text}")
        with open(os.path.join(tmp, "result.0.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)


# a rank's error that only reports a peer's loss (its collective's
# connection closed under it): the peer failed first
_PEER_LOSS = ("connection closed by peer", "connection reset by peer",
              "broken pipe")


def _first_failure(tmp, procs, exited):
    """The rank that failed first for a reason of its own: of the ranks
    that exited nonzero, those whose error (``error.<rank>``, written by
    ``_spawn_rank``) is not a lost peer, else all of them; the earliest by
    the error's time, or by the exit for a rank that wrote none (killed,
    or ended by ``os._exit``)."""
    seen = []
    for r, p in enumerate(procs):
        if p.exitcode in (None, 0):
            continue
        path = os.path.join(tmp, f"error.{r}")
        t, peer_loss = exited.get(r, time.time()), False
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                t_s, _, msg = f.read().partition(" ")
            t = float(t_s)
            peer_loss = any(m in msg.lower() for m in _PEER_LOSS)
        seen.append((peer_loss, t, r))
    own = [x for x in seen if not x[0]] or seen
    return min(own, key=lambda x: x[1])[2]


def _log(tmp, rank):
    path = os.path.join(tmp, f"workerlog.{rank}")
    if not os.path.exists(path):
        return ""
    with open(path, errors="replace") as f:
        return f.read()


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + 5
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
        if p.is_alive():
            p.kill()
            p.join()


def _spawn_rank(func, args, rank, tmp):
    """A rank process of ``spawn``: its output to its log, the group,
    ``func``; rank 0 writes its result for the parent."""
    log = open(os.path.join(tmp, f"workerlog.{rank}"), "w")
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    try:
        init_parallel_env()
        result = func(*args)
        if rank == 0:
            part = os.path.join(tmp, "result.0.pkl.part")
            with open(part, "wb") as f:
                pickle.dump(result, f)
            os.replace(part, os.path.join(tmp, "result.0.pkl"))
    except BaseException as e:
        # when it failed, and why, for the parent's naming of the rank
        # that failed first (written before the group is left)
        with open(os.path.join(tmp, f"error.{rank}"), "w") as f:
            f.write(f"{time.time()!r} {type(e).__name__}: {e}")
        raise
    finally:
        destroy_parallel_env()
        sys.stdout.flush()
        sys.stderr.flush()
