"""Parallel environment at one process.

Counterpart of ``paddle_tpu/distributed/parallel_env.py``.  The JAX
package bootstraps ``jax.distributed`` from the launcher's environment and
builds a ``jax.sharding.Mesh`` over every visible device; the port runs
one process on one card and runs it unsharded, so it builds no mesh:
``init_parallel_env()`` leaves ``get_mesh()`` at ``None`` (the JAX package
returns a one-device ``Mesh`` there) and ``get_world_size()`` is 1.  What
needs several processes or devices raises the port's later-slice error,
naming ROADMAP Queue A item 8: ``PADDLE_TRAINERS_NUM > 1``, a
``mesh_shape`` or ``set_mesh`` spanning more than one device, and
``FLAGS_pp_degree`` / ``FLAGS_ep_degree`` above 1.

Env contract (the names the reference launcher exports):
  PADDLE_TRAINER_ID        process index (``get_rank``)
  PADDLE_TRAINERS_NUM      number of processes (1 here)
  PADDLE_TRAINER_ENDPOINTS comma list of the trainers' endpoints
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

from ..framework import flags as _flags

_mesh = None
_ring_axes: Dict[int, object] = {}


def later(what: str) -> NotImplementedError:
    """The error for what needs several processes or devices."""
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet: several processes, device "
        f"meshes and their collectives come with a later slice of the port "
        f"(ROADMAP Queue A item 8)")


def process_count() -> int:
    """Processes of the job, from ``PADDLE_TRAINERS_NUM`` (default 1)."""
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)


def init_parallel_env(mesh_shape: Optional[Sequence[int]] = None,
                      axis_names: Optional[Sequence[str]] = None):
    """One process, one card: checks that nothing asks for more, and
    returns ``get_mesh()`` (``None`` unless ``set_mesh`` stored one)."""
    if process_count() > 1:
        raise later(f"PADDLE_TRAINERS_NUM={process_count()} (several "
                    f"processes)")
    degrees = {"pp_degree": _flags.flag("pp_degree"),
               "ep_degree": _flags.flag("ep_degree")}
    for name, degree in degrees.items():
        if int(degree or 0) > 1:
            raise later(f"FLAGS_{name}={degree}")
    if mesh_shape is not None and math.prod(int(s) for s in mesh_shape) > 1:
        raise later(f"a mesh of shape {tuple(mesh_shape)}")
    return _mesh


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
    """Data-parallel world size (the reference's nranks): 1."""
    return 1


def get_rank() -> int:
    """The process's rank: ``PADDLE_TRAINER_ID`` when set, else 0."""
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
        return 0

    local_rank = rank
    nranks = world_size
