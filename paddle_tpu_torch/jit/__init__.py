"""``paddle.jit`` namespace (reference python/paddle/jit/__init__.py),
re-exporting the trace-based dygraph jit machinery of ``dygraph/jit.py``
and its ``to_static`` entry point."""
from ..dygraph.jit import (  # noqa: F401
    StaticFunction,
    TracedLayer,
    TranslatedLayer,
    declarative,
    load,
    save,
    to_static,
)

__all__ = ["save", "load", "to_static", "declarative", "TracedLayer",
           "TranslatedLayer", "StaticFunction"]
