"""``paddle_tpu_torch.distributed`` -- ``paddle.distributed``.

Counterpart of ``paddle_tpu/distributed``, one process a card:

- ``parallel_env``: ``init_parallel_env`` (a ``torch.distributed`` group
  from the launcher's environment above one process), ``get_rank``,
  ``get_world_size``, ``get_mesh`` (``None``: the port builds no mesh),
  ``set_mesh`` / ``reset_mesh``, ``ParallelEnv``;
- ``launch``: ``python -m paddle_tpu_torch.distributed.launch
  --nproc_per_node N script.py``;
- ``fleet``: ``fleet.init``, ``DistributedStrategy`` (its message written
  out without protobuf, ``distributed_strategy_schema``), the role makers,
  ``distributed_optimizer`` / ``minimize`` over the meta-optimizer chain
  (amp, recompute, gradient merge, LARS, LAMB, DGC, and above one rank
  the gradient-allreduce transpile, ``fleet.collective_transpiler``),
  and ``fleet.elastic``'s fault injection and device preflight;
- the collective functions (``all_reduce``, ``broadcast``, ...) over the
  ``c_*`` lowerings of ``ops/collective.py``;
- ``DataParallel``, ``prepare_context`` and ``spawn`` (one process);
- ``checkpoint`` (``save_sharded`` / ``load_sharded`` at one process).

LocalSGD, ZeRO, ``spawn(nprocs > 1)``, several-process checkpoints,
device meshes (pipeline, tensor and expert parallelism) and the sharded
embedding (``distributed.embedding``) raise or are absent until later
slices of ROADMAP Queue A item 8.  Importing this package builds no
kernel and touches no card.
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
