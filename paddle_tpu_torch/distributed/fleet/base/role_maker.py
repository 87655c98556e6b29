"""RoleMaker: the job's topology from the launcher's environment.

Counterpart of ``paddle_tpu/distributed/fleet/base/role_maker.py``
(reference fleet/base/role_maker.py:33, PaddleCloudRoleMaker's env
parsing :363): ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``.  The JAX package's barrier and all-gather
ride ``jax.experimental.multihost_utils``; the port's cross the ranks
through the live ``torch.distributed`` group (``barrier``,
``all_gather_object``).  At one process both are trivial: ``_barrier``
does nothing and ``_all_gather`` returns ``[obj]``.  A role of several
workers without a live group (``init_parallel_env`` not called) raises.
"""
from __future__ import annotations

import os

from ...parallel_env import group_live


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def _is_worker(self):
        raise NotImplementedError

    def _worker_num(self):
        raise NotImplementedError

    def _worker_index(self):
        raise NotImplementedError

    def _is_first_worker(self):
        return self._is_worker() and self._worker_index() == 0


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
        self._size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._endpoints = [e for e in eps.split(",") if e]
        self._role = Role.WORKER

    def _is_worker(self):
        return self._role == Role.WORKER

    def _is_server(self):
        return self._role == Role.SERVER

    def _worker_num(self):
        return self._size

    def _worker_index(self):
        return self._rank

    def _get_trainer_endpoints(self):
        return list(self._endpoints)

    def _group(self, what):
        if not group_live():
            raise RuntimeError(
                f"a {what} across {self._size} workers needs the process "
                f"group: call fleet.init(is_collective=True) or "
                f"distributed.init_parallel_env() first")
        import torch.distributed as dist

        return dist

    def _barrier(self, comm_world="worker"):
        if self._size > 1:
            self._group(f"{comm_world} barrier").barrier()

    def _all_gather(self, obj, comm_world="worker"):
        if self._size <= 1:
            return [obj]
        dist = self._group("all-gather")
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, current_id=0, worker_num=1, role=Role.WORKER, **kwargs):
        super().__init__(is_collective=True)
        self._rank = current_id
        self._size = worker_num
        self._role = role
