"""``paddle.incubate``-role namespace (reference fluid/incubate);
counterpart of ``paddle_tpu/incubate``."""
from . import checkpoint  # noqa: F401
