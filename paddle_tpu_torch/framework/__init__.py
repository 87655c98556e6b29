"""Framework pieces of the PyTorch port: the FLAGS registry, devices
(``place``), the program IR and its builders' helpers (``program``,
``dtypes``, ``unique_name``, ``backward``), runtime storage (``scope``),
the lowering registry and the static-graph ``Executor``.  Counterpart of
``paddle_tpu/framework``."""
from .executor import Executor, run_startup  # noqa: F401
from .place import CPUPlace, CUDAPlace  # noqa: F401
from .program import (  # noqa: F401
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .scope import Scope, global_scope, scope_from_numpy  # noqa: F401
