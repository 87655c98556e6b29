"""``RecordEvent`` for the PyTorch port.

Counterpart of ``RecordEvent`` in ``paddle_tpu/profiler.py``, which
wraps ``jax.profiler.TraceAnnotation``.  Here the annotation is
``torch.profiler.record_function``, so a named span shows on a
``torch.profiler`` trace beside the CUDA kernels it launched, and it
dual-feeds the in-process span tracer (``observe/tracer.py``) exactly
as the JAX one does.  Capture itself (``start_profiler`` and friends)
waits for the port of the observability stack.
"""
from __future__ import annotations

import functools
import threading

from .observe import tracer as _otracer


class RecordEvent:
    """Scoped host-side annotation: a context manager, explicit
    ``begin()``/``end()``, or a function decorator."""

    def __init__(self, name: str):
        self.name = name
        # per-thread LIFO of live annotations, so one instance can be
        # shared across threads or re-entered
        self._local = threading.local()

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with RecordEvent(self.name):
                return fn(*args, **kwargs)

        return wrapped

    def _entries(self):
        st = getattr(self._local, "entries", None)
        if st is None:
            st = self._local.entries = []
        return st

    def begin(self):
        import torch

        _otracer.begin(self.name)
        ann = torch.profiler.record_function(self.name)
        ann.__enter__()
        self._entries().append(ann)

    def end(self):
        entries = self._entries()
        if entries:
            entries.pop().__exit__(None, None, None)
        _otracer.end()

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False
