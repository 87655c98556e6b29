"""paddle_tpu_torch.serving -- the serving layer of the PyTorch port.

Counterpart of ``paddle_tpu.serving``:

- the one-shot path: ``Server`` (server.py) batches concurrent
  ``infer`` calls through the dynamic micro-batcher (batcher.py) into
  shape buckets (buckets.py) run by an ``inference.Predictor``, whose
  executor replays each bucket's captured step on the card;
- the generative path: ``DecodeServer`` -> ``DecodeEngine`` ->
  ``TransformerLM`` over the paged KV cache (``kv_cache.py``), with
  prefix sharing, copy-on-write, chunked prefill, ragged prefill
  packing, speculative decoding with a draft model, continuous
  batching, deadlines and streaming; ``DisaggServer`` (disagg.py) splits
  replicas into prefill and decode roles joined by KV-page migration,
  with an SLO-driven ``Autoscaler``.

The attention of every step runs in the hand-written CUDA kernels of
``ops/paged_attention.py`` on the card.  Importing this package builds
no kernel.
"""
from .batcher import Batcher, InferenceRequest, RequestBase  # noqa: F401
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
    quantize_moe_weights,
    shard_moe_weights,
    weights_from_numpy,
)
from .disagg import (  # noqa: F401
    Autoscaler,
    DisaggConfig,
    DisaggRequest,
    DisaggServer,
)
from .kv_cache import (  # noqa: F401
    CacheConfig,
    CacheExhaustedError,
    KVPageExport,
    PagedKVCache,
    PageAllocator,
    PrefixIndex,
)
from .server import (  # noqa: F401
    DecodeServer,
    Server,
    ServingConfig,
    least_loaded_order,
)

__all__ = [
    "Autoscaler", "Batcher", "BucketSpec", "CacheConfig",
    "CacheExhaustedError", "DeadlineExceededError", "DecodeConfig",
    "DecodeEngine", "DecodeRequest", "DecodeServer", "DisaggConfig",
    "DisaggRequest", "DisaggServer", "InferenceRequest",
    "KVPageExport", "PageAllocator", "PagedKVCache", "PrefixIndex",
    "QueueFullError", "RequestAbandonedError", "RequestBase",
    "RequestTooLargeError", "Server", "ServerClosedError",
    "ServingConfig", "ServingError", "TransformerLM",
    "least_loaded_order", "prefill_bucket_grid", "quantize_moe_weights",
    "shard_moe_weights", "weights_from_numpy",
]
