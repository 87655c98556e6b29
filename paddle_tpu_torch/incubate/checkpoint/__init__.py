from . import auto_checkpoint  # noqa: F401
