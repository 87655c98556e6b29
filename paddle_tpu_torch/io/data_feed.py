"""MultiSlotDataFeed: file-sharded reader for MultiSlot text data.

Counterpart of ``paddle_tpu/io/data_feed.py`` (reference
framework/data_feed.{h,cc}, MultiSlotDataFeed:117, feeding PS-style
trainers).  The parse loop is host C++ (``paddle_tpu_torch/native``,
``csrc/data_feed.cc``); this class shards files, batches instances, and
yields per-slot (values, lod) numpy pairs -- LoD level-0 semantics,
dense slots (a declared ``dim``) reshaped to [batch, dim].  Batches stay
on the host: the caller feeds them to ``Executor.run``, which moves them
to the device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .. import native


class MultiSlotDataFeed:
    """``slots`` is a list of (name, type) or (name, type, dim) with type
    'f' (float values) or 'u' (uint64 ids), in the file's slot order.
    Declaring ``dim`` makes the slot DENSE: every instance must carry
    exactly ``dim`` values and batches come out as [batch, dim] arrays
    (deterministic shape); undeclared slots always yield flat values +
    lod offsets, even when a batch happens to be uniform."""

    def __init__(self, slots: Sequence[Tuple], batch_size: int):
        self.slots = [(s[0], s[1], s[2] if len(s) > 2 else None)
                      for s in slots]
        self.types = "".join(t for _, t, _ in self.slots)
        self.batch_size = int(batch_size)

    def parse(self, data: bytes):
        return native.parse_multislot(data, self.types)

    def read_file(self, path: str):
        with open(path, "rb") as f:
            n, parsed = self.parse(f.read())
        yield from self._batches(n, parsed)

    def read_files(self, paths: Sequence[str]):
        for p in paths:
            yield from self.read_file(p)

    def _batches(self, n: int, parsed):
        bs = self.batch_size
        # the final partial batch is yielded too (reference DataFeed
        # semantics: no silent data drop)
        for start in range(0, n, bs):
            cur = min(bs, n - start)
            batch: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            for (name, _t, dim), (vals, lod) in zip(self.slots, parsed):
                lo, hi = lod[start], lod[start + cur]
                blod = lod[start:start + cur + 1] - lod[start]
                v = vals[lo:hi]
                if dim is not None:
                    widths = np.diff(blod)
                    if widths.size and not (widths == dim).all():
                        raise ValueError(
                            f"dense slot {name!r} declared dim {dim} but "
                            f"instances carry widths "
                            f"{sorted(set(widths.tolist()))}")
                    v = v.reshape(cur, int(dim))
                batch[name] = (v, blod)
            yield batch
