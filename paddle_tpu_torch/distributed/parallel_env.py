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
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Optional, Sequence

import torch

from ..framework import flags as _flags
from ..framework.place import selected_gpu

_mesh = None
_ring_axes: Dict[int, object] = {}

BACKENDS = ("nccl", "gloo")
# how long a rank waits for the others at the rendezvous and in a
# collective before the group raises
GROUP_TIMEOUT_S = 600


def later(what: str) -> NotImplementedError:
    """The error for what waits for a later slice of item 8."""
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet: it comes with a later "
        f"slice of ROADMAP Queue A item 8 (spawn and the elastic "
        f"supervisor, then the device meshes: tensor, pipeline and "
        f"expert parallelism)")


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
    if name == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PADDLE_DISTRI_BACKEND=nccl needs a CUDA card and torch "
                "sees none; the CPU runs its ranks with "
                "PADDLE_DISTRI_BACKEND=gloo")
        torch.cuda.set_device(selected_gpu())
    dist.init_process_group(
        name, init_method=f"tcp://{coord}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    # one eager collective: under NCCL it builds the communicator on this
    # card before any step is captured; under gloo it proves the ring
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
