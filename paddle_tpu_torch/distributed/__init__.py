"""``paddle_tpu_torch.distributed`` -- ``paddle.distributed`` at one process.

Counterpart of ``paddle_tpu/distributed`` for a job of one process on one
card:

- ``parallel_env``: ``init_parallel_env``, ``get_rank``,
  ``get_world_size`` (1), ``get_mesh`` (``None``: the port shards
  nothing), ``set_mesh`` / ``reset_mesh``, ``ParallelEnv``;
- ``fleet``: ``fleet.init``, ``DistributedStrategy`` (its message written
  out without protobuf, ``distributed_strategy_schema``), the role makers,
  ``distributed_optimizer`` / ``minimize`` over the single-process
  meta-optimizer chain (amp, recompute, gradient merge, LARS, LAMB, DGC),
  and ``fleet.elastic``'s fault injection and device preflight;
- the collective functions (``all_reduce``, ``broadcast``, ...) over the
  one-rank ``c_*`` lowerings of ``ops/collective.py``;
- ``DataParallel``, ``prepare_context`` and ``spawn``;
- ``checkpoint`` (``save_sharded`` / ``load_sharded`` at one process).

Several processes, device meshes, the collective transpiler, ZeRO,
pipeline and tensor/expert parallelism and the sharded embedding
(``distributed.embedding``) raise or are absent until ROADMAP Queue A
item 8.  Importing this package builds no kernel and touches no card.
"""
from . import fleet  # noqa: F401
from .collective import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_reduce,
    barrier,
    broadcast,
    get_rank,
    get_world_size,
    reduce,
    scatter,
)
from .parallel import DataParallel, prepare_context, spawn  # noqa: F401
from .parallel_env import (  # noqa: F401
    ParallelEnv,
    get_mesh,
    init_parallel_env,
    reset_mesh,
    set_mesh,
)
