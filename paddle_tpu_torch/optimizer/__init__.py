"""Static-graph optimizers of the port (``paddle.optimizer`` names).

Counterpart of ``paddle_tpu/optimizer/__init__.py``, reduced to the
fluid-style program builders of ``static_opt`` (a copy of the JAX
package's): ``minimize`` appends the backward and update ops that the
executor lowers.  The 2.0 dygraph ``Optimizer.step`` and the pipeline
optimizer come with later slices of the port.
"""
from .. import optimizer_lr as lr  # noqa: F401  (paddle.optimizer.lr.*)
from .static_opt import (  # noqa: F401
    AdadeltaOptimizer,
    AdagradOptimizer,
    AdamaxOptimizer,
    AdamOptimizer,
    AdamWOptimizer,
    DpsgdOptimizer,
    ExponentialMovingAverage,
    FtrlOptimizer,
    LambOptimizer,
    LarsMomentumOptimizer,
    LookaheadOptimizer,
    ModelAverage,
    MomentumOptimizer,
    Optimizer,
    RMSPropOptimizer,
    SGDOptimizer,
)
