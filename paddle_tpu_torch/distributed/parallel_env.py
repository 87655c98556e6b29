"""Parallel environment: the process group from the launcher's environment.

Counterpart of ``paddle_tpu/distributed/parallel_env.py``.  The JAX
package runs one process per host driving all of that host's chips:
``jax.distributed.initialize`` is its rendezvous and a ``Mesh`` over
every device replaces each ring.  The port runs one process per card, as
the reference does, with the same env contract: ``init_parallel_env()``
with ``PADDLE_TRAINERS_NUM > 1`` starts a ``torch.distributed`` process
group, whose rendezvous is a TCP store at the coordinator, and the
program's ``c_*`` ops call ``torch.distributed`` on it
(``ops/collective.py``).  Data parallelism is that process group: the
port builds no mesh, so ``get_mesh()`` stays ``None`` (a difference by
design; the JAX package returns a ``Mesh`` there).

Env contract (the names the reference launcher exports):
  PADDLE_TRAINER_ID        process index (``get_rank``)
  PADDLE_TRAINERS_NUM      number of processes (``get_world_size``)
  PADDLE_COORDINATOR       the rendezvous' ip:port
  PADDLE_TRAINER_ENDPOINTS comma list; its first entry is the
                           rendezvous when PADDLE_COORDINATOR is unset
  PADDLE_DISTRI_BACKEND    ``nccl`` (the default) or ``gloo``
  FLAGS_selected_gpus      this process's card (``framework/place``)

A job of one process starts a group only when ``PADDLE_DISTRI_BACKEND``
names a backend.  Under NCCL the communicator is built at
``init_parallel_env`` by one eager all-reduce on the process's card, so
that a captured step finds it ready.  What needs a device mesh still
raises the later-slice error, naming what is left of ROADMAP Queue A
item 8: a ``mesh_shape`` or ``set_mesh`` spanning more than one device,
and ``FLAGS_pp_degree`` / ``FLAGS_ep_degree`` above 1.

After a rank dies, the elastic supervisor's ``train_fn`` re-forms the
group over the survivors with ``_join_survivors`` (the counterpart of
the JAX package's ``train_fn`` building a mesh over the surviving
devices): a fresh rendezvous that the lowest surviving rank hosts and
publishes on the job's KV server, each wait bounded, and the env
contract rewritten to the new world.
"""
from __future__ import annotations

import datetime
import math
import os
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional, Sequence

import torch

from ..framework import flags as _flags
from ..framework.place import selected_gpu

_mesh = None
_ring_axes: Dict[int, object] = {}

BACKENDS = ("nccl", "gloo")
# how long a rank waits for the others at the rendezvous and in a
# collective before the group raises
GROUP_TIMEOUT_S = 600
# how long a survivor waits for the others when the group is re-formed
# (``_join_survivors``) before its attempt fails: a peer that died never
# arrives, and the supervisor classifies the failure and retries
REJOIN_TIMEOUT_S = 30.0
# the KV server's key of a re-formed group's rendezvous: <prefix>/<ranks>
# holds the host's store address and a nonce
RENDEZVOUS_KEY = "elastic_rendezvous"


def later(what: str) -> NotImplementedError:
    """The error for what waits for a later slice of item 8."""
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet: it comes with a later "
        f"slice of ROADMAP Queue A item 8 (the device meshes: tensor, "
        f"pipeline and expert parallelism)")


def process_count() -> int:
    """Processes of the job, from ``PADDLE_TRAINERS_NUM`` (default 1)."""
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)


def group_live() -> bool:
    """Whether this process joined a ``torch.distributed`` group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The live group's backend (``"nccl"`` / ``"gloo"``), else None."""
    if not group_live():
        return None
    import torch.distributed as dist

    return str(dist.get_backend())


def requested_backend() -> str:
    """``PADDLE_DISTRI_BACKEND``, checked (default ``nccl``)."""
    name = os.environ.get("PADDLE_DISTRI_BACKEND", "") or "nccl"
    if name not in BACKENDS:
        raise ValueError(
            f"PADDLE_DISTRI_BACKEND={name!r} is not a backend the port "
            f"runs; set it to one of {list(BACKENDS)}")
    return name


def coordinator() -> str:
    """The rendezvous' ``ip:port``: ``PADDLE_COORDINATOR``, else the first
    of ``PADDLE_TRAINER_ENDPOINTS``."""
    coord = os.environ.get("PADDLE_COORDINATOR", "")
    if not coord:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        coord = eps.split(",")[0] if eps else ""
    if not coord:
        raise ValueError(
            "a process group needs its rendezvous: set PADDLE_COORDINATOR "
            "(ip:port) or PADDLE_TRAINER_ENDPOINTS (the first entry is the "
            "rendezvous), as the launcher "
            "(python -m paddle_tpu_torch.distributed.launch) does")
    return coord


def init_parallel_env(mesh_shape: Optional[Sequence[int]] = None,
                      axis_names: Optional[Sequence[str]] = None):
    """Join the job's process group when the environment asks for one
    (``PADDLE_TRAINERS_NUM > 1``, or a ``PADDLE_DISTRI_BACKEND`` at one
    process) and return ``get_mesh()`` (``None`` unless ``set_mesh``
    stored a one-device mesh).  Idempotent."""
    degrees = {"pp_degree": _flags.flag("pp_degree"),
               "ep_degree": _flags.flag("ep_degree")}
    for name, degree in degrees.items():
        if int(degree or 0) > 1:
            raise later(f"FLAGS_{name}={degree}")
    if mesh_shape is not None and math.prod(int(s) for s in mesh_shape) > 1:
        raise later(f"a mesh of shape {tuple(mesh_shape)}")
    n = process_count()
    if not group_live() and (n > 1 or os.environ.get(
            "PADDLE_DISTRI_BACKEND")):
        _start_group(n)
    return _mesh


def _start_group(world: int) -> None:
    import torch.distributed as dist

    name = requested_backend()
    coord = coordinator()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    if not 0 <= rank < world:
        raise ValueError(f"PADDLE_TRAINER_ID={rank} is outside "
                         f"PADDLE_TRAINERS_NUM={world}")
    _select_card(name)
    dist.init_process_group(
        name, init_method=f"tcp://{coord}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    _probe(name)


def _select_card(name: str) -> None:
    if name == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PADDLE_DISTRI_BACKEND=nccl needs a CUDA card and torch "
                "sees none; the CPU runs its ranks with "
                "PADDLE_DISTRI_BACKEND=gloo")
        torch.cuda.set_device(selected_gpu())


def _probe(name: str) -> None:
    """One eager collective: under NCCL it builds the communicator on
    this card before any step is captured; under gloo it proves the
    ring."""
    import torch.distributed as dist

    dev = torch.device("cuda", selected_gpu()) if name == "nccl" \
        else torch.device("cpu")
    probe = torch.zeros(1, device=dev)
    dist.all_reduce(probe)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def destroy_parallel_env() -> None:
    """Leave the process group (a no-op without one)."""
    if group_live():
        import torch.distributed as dist

        dist.destroy_process_group()


def _kv_url(endpoint: str, key: str) -> str:
    base = endpoint.rstrip("/")
    if not base.startswith("http"):
        base = "http://" + base
    return f"{base}/{key}"


def _kv_put(endpoint: str, key: str, value: str) -> None:
    req = urllib.request.Request(_kv_url(endpoint, key),
                                 data=value.encode(), method="PUT")
    with urllib.request.urlopen(req, timeout=5):
        pass


def _kv_get(endpoint: str, key: str) -> Optional[str]:
    """The value at ``key``, or None when the server has none (or cannot
    be reached: the caller's deadline bounds the retries)."""
    try:
        with urllib.request.urlopen(_kv_url(endpoint, key), timeout=5) as r:
            return r.read().decode()
    except (urllib.error.URLError, TimeoutError):
        return None


def _kv_delete(endpoint: str, key: str) -> None:
    try:
        urllib.request.urlopen(urllib.request.Request(
            _kv_url(endpoint, key), method="DELETE"), timeout=5)
    except (urllib.error.URLError, TimeoutError):
        pass


def _set_world(index: int, world: int, coord: Optional[str]) -> None:
    """Rewrite the env contract to a world of ``world`` processes with
    this one at ``index``; at one process no group is asked for."""
    os.environ["PADDLE_TRAINER_ID"] = str(index)
    os.environ["PADDLE_TRAINERS_NUM"] = str(world)
    if coord is None:
        os.environ.pop("PADDLE_DISTRI_BACKEND", None)
    else:
        os.environ["PADDLE_COORDINATOR"] = coord
        os.environ["PADDLE_TRAINER_ENDPOINTS"] = coord


def _join_survivors(ranks: Sequence[int], job_rank: int,
                    kv_endpoint: str,
                    timeout_s: float = REJOIN_TIMEOUT_S,
                    dead_ranks_fn: Optional[Callable[[], Sequence[int]]]
                    = None) -> None:
    """Join the process group over the job ranks ``ranks`` (an elastic
    supervisor's ``Topology.ranks``: the survivors) as the index of
    ``job_rank`` among them.

    - A live group of that size in which this process holds that index
      is kept (the first attempt, on the launcher's group).
    - One rank: no group; the environment becomes a one-process job's.
    - Else the lowest surviving rank starts a TCP store on a free port
      and publishes it with a nonce under ``elastic_rendezvous/<ranks>``
      on the job's KV server (``kv_endpoint``); the others read it; all
      meet at a ``ckpt.KVBarrier`` named by the nonce, then start the
      group on that store.  Each wait ends within ``timeout_s``, and at
      once when ``dead_ranks_fn`` (the health plane's dead-listed job
      ranks) names a rank waited for: a re-join with a dead peer fails
      in seconds, never at ``GROUP_TIMEOUT_S``.

    On success the env contract (``PADDLE_TRAINER_ID``,
    ``PADDLE_TRAINERS_NUM``, ``PADDLE_COORDINATOR``) names the new
    world, so every reader of it (the role makers, ``ParallelEnv``, a
    loader's workers) sees the survivors' world."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    from ..ckpt.manager import KVBarrier

    ranks = sorted(int(r) for r in ranks)
    if job_rank not in ranks:
        raise ValueError(f"rank {job_rank} is not among the survivors "
                         f"{ranks}")
    index, world = ranks.index(job_rank), len(ranks)
    if group_live():
        if get_world_size() == world and get_rank() == index:
            return
        destroy_parallel_env()
    if world == 1:
        _set_world(0, 1, None)
        return
    name = requested_backend()
    _select_card(name)
    deadline = time.monotonic() + float(timeout_s)
    key = f"{RENDEZVOUS_KEY}/{'-'.join(map(str, ranks))}"

    def dead_indices():
        # the health plane speaks job ranks; the barrier, indices
        dead = dead_ranks_fn() if dead_ranks_fn is not None else ()
        return [ranks.index(int(r)) for r in dead if int(r) in ranks]

    def remaining() -> float:
        return max(deadline - time.monotonic(), 1.0)

    if index == 0:
        host = os.environ.get("POD_IP") or coordinator().rsplit(":", 1)[0]
        store = dist.TCPStore(
            host, 0, world, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=remaining()))
        addr, nonce = f"{host}:{store.port}", f"{os.getpid()}-{time.time_ns()}"
        _kv_put(kv_endpoint, key, f"{addr} {nonce}")
    else:
        while True:
            got = _kv_get(kv_endpoint, key)
            if got:
                break
            if 0 in dead_indices() or time.monotonic() >= deadline:
                raise RuntimeError(
                    f"re-forming the group over ranks {ranks}: the host "
                    f"(rank {ranks[0]}) published no store within "
                    f"{timeout_s} s, or was dead-listed (KV server "
                    f"{kv_endpoint})")
            time.sleep(0.02)
        addr, nonce = got.split()
    try:
        KVBarrier(kv_endpoint, index, world, timeout=remaining(),
                  prefix=f"{key}:{nonce}",
                  dead_ranks_fn=dead_indices)("rendezvous")
        if index:
            host, port = addr.rsplit(":", 1)
            store = dist.TCPStore(
                host, int(port), world, is_master=False,
                timeout=datetime.timedelta(seconds=remaining()))
        dist.init_process_group(
            name, store=store, rank=index, world_size=world,
            timeout=datetime.timedelta(seconds=remaining()))
    finally:
        if index == 0:   # the address goes with the host's rendezvous
            _kv_delete(kv_endpoint, key)
    # the rendezvous was bounded; the group's collectives then get the
    # launcher's group's timeout
    distributed_c10d._set_pg_timeout(
        datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    _probe(name)
    _set_world(index, world, addr)


def get_mesh():
    return _mesh


def set_mesh(mesh, ring_axes: Optional[Dict[int, object]] = None):
    """Store a one-device mesh object (the port shards nothing over it);
    a mesh over several devices raises the later-slice error."""
    global _mesh, _ring_axes
    size = int(getattr(mesh, "size", 1)) if mesh is not None else 1
    if size > 1:
        raise later(f"set_mesh over {size} devices")
    _mesh = mesh
    if ring_axes is not None:
        _ring_axes = dict(ring_axes)
    return _mesh


def reset_mesh():
    global _mesh, _ring_axes
    _mesh = None
    _ring_axes = {}


def ring_axes() -> Dict[int, object]:
    return dict(_ring_axes)


def get_world_size() -> int:
    """Data-parallel world size (the reference's nranks): the live
    group's size, else 1."""
    if group_live():
        import torch.distributed as dist

        return int(dist.get_world_size())
    return 1


def get_rank() -> int:
    """The process's rank: the live group's, else ``PADDLE_TRAINER_ID``
    when set, else 0."""
    if group_live():
        import torch.distributed as dist

        return int(dist.get_rank())
    rid = os.environ.get("PADDLE_TRAINER_ID")
    return int(rid) if rid not in (None, "") else 0


class ParallelEnv:
    """Reference fluid.dygraph.ParallelEnv parity."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return max(get_world_size(), process_count())

    @property
    def device_id(self):
        return selected_gpu()

    local_rank = rank
    nranks = world_size
