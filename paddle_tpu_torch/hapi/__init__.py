"""High-level API (reference python/paddle/hapi/); counterpart of
``paddle_tpu/hapi/__init__.py``."""
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    BenchmarkCallback,
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
)
from .model import InputSpec, Model  # noqa: F401
