"""Fleet: the distributed-training facade.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py`` (reference
python/paddle/distributed/fleet/base/fleet_base.py: fleet.init:125,
worker_num/worker_index, distributed_optimizer:554, minimize:946).
``init`` joins the job's process group (``init_parallel_env``: one
process a card, no mesh), ``worker_num`` / ``worker_index`` /
``barrier_worker`` read and cross the live group, ``minimize`` compiles
the strategy's meta-optimizer chain (``meta_optimizers.compile_strategy``;
above one rank it ends in the gradient-allreduce transpile) and runs it,
and the executor runs the program it builds.  ``elastic`` (the fault injection and device
preflight) is imported lazily; the sharded ``distributed_embedding``
waits for ROADMAP Queue A item 8.
"""
from __future__ import annotations

from typing import Optional

from ..parallel_env import get_mesh, get_rank, get_world_size, init_parallel_env
from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import PaddleCloudRoleMaker, RoleMakerBase, UserDefinedRoleMaker
from .meta_optimizers import compile_strategy


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._user_optimizer = None
        self._is_collective = True
        self._inited = False

    # -- lifecycle --------------------------------------------------------
    def init(self, role_maker=None, is_collective=True, strategy=None):
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._is_collective = is_collective
        self._strategy = strategy or DistributedStrategy()
        if is_collective and get_mesh() is None:
            init_parallel_env()
        self._inited = True
        return self

    # -- topology queries -------------------------------------------------
    def is_first_worker(self) -> bool:
        return self.worker_index() == 0

    def worker_index(self) -> int:
        return get_rank()

    def worker_num(self) -> int:
        return max(get_world_size(), 1)

    def is_worker(self) -> bool:
        return self._role_maker is None or self._role_maker._is_worker()

    def worker_endpoints(self, to_string=False):
        eps = (self._role_maker._get_trainer_endpoints()
               if self._role_maker else [])
        return ",".join(eps) if to_string else eps

    def is_server(self) -> bool:
        return bool(self._role_maker and getattr(
            self._role_maker, "_is_server", lambda: False)())

    def barrier_worker(self):
        if self._role_maker:
            self._role_maker._barrier("worker")

    # parameter-server API, kept so user scripts import (the runtime is
    # collective, as in the JAX package)
    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        raise NotImplementedError(
            "parameter-server mode is not part of either package's "
            "collective runtime; use is_collective=True")

    def stop_worker(self):
        pass

    # -- optimizer --------------------------------------------------------
    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        self._user_optimizer = optimizer
        return self

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if self._user_optimizer is None:
            raise RuntimeError("call fleet.distributed_optimizer(opt) first")
        chain = compile_strategy(loss, self._role_maker,
                                 self._user_optimizer, self._strategy)
        self._chain = chain
        return chain.minimize(loss, startup_program, parameter_list,
                              no_grad_set)

    @property
    def user_defined_optimizer(self):
        return self._user_optimizer

    @property
    def distributed_strategy(self):
        return self._strategy

    @property
    def applied_chain(self):
        """The meta-optimizer chain the last ``minimize`` ran."""
        return getattr(self, "_chain", None)


def __getattr__(name):
    # fleet.elastic is lazy: most fleet users never touch it
    if name == "elastic":
        import importlib

        mod = importlib.import_module(".elastic", __name__)
        globals()[name] = mod
        return mod
    if name == "distributed_embedding":
        raise AttributeError(
            "fleet.distributed_embedding (the sharded embedding) is not "
            "in the PyTorch port yet: it comes with a later slice of the "
            "port (ROADMAP Queue A item 8)")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


_fleet_singleton = Fleet()

init = _fleet_singleton.init
is_first_worker = _fleet_singleton.is_first_worker
worker_index = _fleet_singleton.worker_index
worker_num = _fleet_singleton.worker_num
is_worker = _fleet_singleton.is_worker
worker_endpoints = _fleet_singleton.worker_endpoints
is_server = _fleet_singleton.is_server
barrier_worker = _fleet_singleton.barrier_worker
init_worker = _fleet_singleton.init_worker
init_server = _fleet_singleton.init_server
run_server = _fleet_singleton.run_server
stop_worker = _fleet_singleton.stop_worker
distributed_optimizer = _fleet_singleton.distributed_optimizer
minimize = _fleet_singleton.minimize

__all__ = [
    "DistributedStrategy", "Fleet", "PaddleCloudRoleMaker",
    "UserDefinedRoleMaker", "elastic", "init", "is_first_worker",
    "worker_index", "worker_num", "is_worker", "barrier_worker",
    "distributed_optimizer", "minimize",
]
