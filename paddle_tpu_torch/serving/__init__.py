"""paddle_tpu_torch.serving — the decode server of the PyTorch port.

Counterpart of the generative half of ``paddle_tpu.serving``:
``DecodeServer`` -> ``DecodeEngine`` -> ``TransformerLM`` over the paged
KV cache (``kv_cache.py``), with prefix sharing, copy-on-write,
chunked prefill, continuous batching, deadlines and streaming.  The
attention of every step runs in the hand-written CUDA kernels of
``ops/paged_attention.py`` on the card.  Importing this package builds
no kernel.
"""
from .batcher import RequestBase  # noqa: F401
from .buckets import (  # noqa: F401
    BucketSpec,
    DeadlineExceededError,
    QueueFullError,
    RequestAbandonedError,
    RequestTooLargeError,
    ServerClosedError,
    ServingError,
    prefill_bucket_grid,
)
from .decode import (  # noqa: F401
    DecodeConfig,
    DecodeEngine,
    DecodeRequest,
    TransformerLM,
    weights_from_numpy,
)
from .kv_cache import (  # noqa: F401
    CacheConfig,
    CacheExhaustedError,
    PagedKVCache,
    PageAllocator,
    PrefixIndex,
)
from .server import DecodeServer, least_loaded_order  # noqa: F401

__all__ = [
    "BucketSpec", "CacheConfig", "CacheExhaustedError",
    "DeadlineExceededError", "DecodeConfig", "DecodeEngine",
    "DecodeRequest", "DecodeServer", "PageAllocator", "PagedKVCache",
    "PrefixIndex", "QueueFullError", "RequestAbandonedError",
    "RequestBase", "RequestTooLargeError", "ServerClosedError",
    "ServingError", "TransformerLM", "least_loaded_order",
    "prefill_bucket_grid", "weights_from_numpy",
]
