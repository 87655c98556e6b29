"""Shape bucketing for the serving layer.

PyTorch port: a copy of ``paddle_tpu/serving/buckets.py`` (no JAX in
it) without the batcher's feed planning (``feed_plans``,
``plan_request``, ``assemble``, ``bucket_feed_specs``), which waits for
the static-graph slice.  The decode engine uses the bucket grid to pad
prompts, so the set of prefill shapes stays small, and the errors.

The Executor's compile cache holds one XLA executable per distinct feed
shape, so a variable-length request stream compiles an executable per
length — a compile storm that leaves the chip idle exactly when traffic
arrives.  A ``BucketSpec`` pins the shape universe up front: every
request is padded UP to the smallest configured (batch-size,
sequence-length) bucket that holds it, so the cache holds exactly
``len(batch_sizes) * len(seq_lens)`` executables and the serving warmup
can pre-compile all of them before the first request.

Padding contract: the pad value (default 0) must be semantically inert
for the model — true for row-wise inference nets whose padded positions
are masked or contribute zeros (embedding-sum, relu-matmul chains,
attention with an explicit mask input).  Padded BATCH rows are always
sliced off before results are returned, so only padded SEQUENCE
positions can observe the pad value; symmetrically, a FETCH whose shape
retains a dynamic inner dim is returned padded to its seq bucket (the
server cannot know which output axes track the input length) — reduce
or mask such dims in-model, or slice client-side.
"""
from __future__ import annotations

from typing import Sequence, Tuple


class ServingError(RuntimeError):
    """Base class for serving-layer failures."""


class RequestTooLargeError(ServingError):
    """A request exceeds the largest configured bucket."""


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue is at capacity."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed before a result was produced."""


class ServerClosedError(ServingError):
    """The server is draining or stopped and accepts no new requests."""


class RequestAbandonedError(ServingError):
    """The client explicitly abandoned the request (RequestBase.abandon);
    the engine frees its slot/queue entry at the next boundary."""


class BucketSpec:
    """The static bucket grid: batch sizes x sequence lengths.

    ``batch_sizes`` bounds how many rows one compiled executable
    processes; ``seq_lens`` bounds every dynamic (declared ``-1``)
    non-batch feed dim.  ``seq_lens=None`` means the model has no
    dynamic inner dims (or the caller accepts one executable per
    distinct inner shape).
    """

    def __init__(self, batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 seq_lens: Sequence[int] = None):
        bs = sorted({int(b) for b in batch_sizes})
        if not bs or bs[0] < 1:
            raise ValueError(f"batch_sizes must be positive ints, got "
                             f"{batch_sizes!r}")
        self.batch_sizes: Tuple[int, ...] = tuple(bs)
        if seq_lens is None:
            self.seq_lens = None
        else:
            sl = sorted({int(s) for s in seq_lens})
            if not sl or sl[0] < 1:
                raise ValueError(f"seq_lens must be positive ints, got "
                                 f"{seq_lens!r}")
            self.seq_lens = tuple(sl)

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def n_buckets(self) -> int:
        return len(self.batch_sizes) * len(self.seq_lens or (None,))

    def batch_bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        raise RequestTooLargeError(
            f"batch of {n} rows exceeds the largest configured batch "
            f"bucket {self.max_batch}")

    def seq_bucket(self, length: int) -> int:
        if self.seq_lens is None:
            return int(length)  # exact-shape mode: no inner padding
        for s in self.seq_lens:
            if s >= length:
                return s
        raise RequestTooLargeError(
            f"sequence length {length} exceeds the largest configured "
            f"seq bucket {self.seq_lens[-1]}")


def prefill_bucket_grid(max_seq_len: int, page_size: int):
    """Prompt-length buckets for the decode engine's prefill compiles
    (serving/decode.py): page-multiple powers of two capped at
    max_seq_len, so the prefill executable universe stays
    O(log(max_seq/page)) and every bucket scatters whole KV pages.

    The rounding buys a tiny executable universe at the price of dead
    query rows — a 65-token prompt dispatches a 128-row executable.
    Every admission must account that waste through
    ``record_pad_waste`` so the cost is measurable (and so ragged
    packing's A/B is visible on old padded rounds too)."""
    out = []
    b = int(page_size)
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(int(max_seq_len))
    return tuple(out)


def record_pad_waste(live_tokens: int, dispatched_tokens: int) -> None:
    """Account one prefill dispatch's padding: ``dispatched - live``
    query rows computed attention for nobody.  Keeps the running
    counters and re-derives the ``prefill_pad_waste`` gauge (cumulative
    padded fraction of all dispatched prefill rows, in parts-per-million
    — the stat registry is integer-only) — the number ragged packing
    (FLAGS_decode_ragged_prefill) exists to drive down."""
    from ..monitor import stat_add, stat_get, stat_set

    live = max(0, int(live_tokens))
    pad = max(0, int(dispatched_tokens) - live)
    stat_add("prefill_padded_tokens_total", pad)
    stat_add("prefill_live_tokens_total", live)
    padded = stat_get("prefill_padded_tokens_total")
    total = padded + stat_get("prefill_live_tokens_total")
    if total:
        stat_set("prefill_pad_waste", int(padded * 1_000_000 / total))
