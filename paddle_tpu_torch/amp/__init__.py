"""Static-graph AMP of the port: ``decorate(optimizer, use_bf16=True)``
rewrites the program with casts (``static_amp``, a copy of the JAX
package's).  Counterpart of ``paddle_tpu/amp/__init__.py``, whose
dygraph ``auto_cast`` and ``GradScaler`` come with a later slice."""
from .lists import AutoMixedPrecisionLists  # noqa: F401
from .static_amp import decorate  # noqa: F401
