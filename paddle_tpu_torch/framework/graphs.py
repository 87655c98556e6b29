"""CUDA-graph capture of a fixed-shape step: the port's counterpart of
XLA compilation ("trace once, run many").

``StepGraph`` holds one step of fixed shapes.  Its first run is eager
(torch needs warm-up iterations before a capture: cuBLAS workspaces,
cuDNN plans, the autograd engine's thread), on a side stream of its own;
the second captures the step on that stream into a
``torch.cuda.CUDAGraph`` and the caller replays it.  Every later run is
a replay: the card runs the recorded kernels with no Python in between.
The executor's compiled-step cache (``framework/executor.py``) and the
decode engine's step (``serving/decode.py``) are its two users.

Nothing falls back: a capture that fails raises, naming the op that
failed when the step's own code raised.

Launch counters.  Each hand-written kernel's wrapper counts its launches
in Python (``<wrapper>.launches``), so a captured kernel would count once,
at the capture, and never again.  While ``StepGraph.capture`` is open,
each wrapper also credits its launch to the tally of the capture whose
stream it was enqueued on (``count_launch``): a graph records exactly the
work queued on its capture stream, whichever thread queued it.  Inside
``torch.cuda.graph`` the capturing thread's current stream is the capture
stream; the autograd engine runs a backward on a worker thread of its
own, on the stream its forward ran on, so a kernel launched by a backward
inside an executor capture lands on the capture's stream too.  A decode
replica launching on its own stream in the same window is credited to no
capture and counts once, as it ran.
The capture takes its tally back out of the counters, and ``replay`` adds
it at every replay: the counts stay those of what the card ran.

Capture mode.  Every capture is ``"thread_local"``: CUDA then forbids the
unsafe calls (a synchronization, an event query) only on the capturing
thread, so a decode replica's host sync or another ``Predictor``'s
allocation on a thread of its own goes on during an executor's capture
(under ``"global"`` such a call on any thread fails, and the capture with
it).  The autograd engine's worker is another thread too: its launches go
to the capture's stream as above, and the capture of a backward needs no
more than that (``chip_smoke.py`` captures every training path's step).
"""
from __future__ import annotations

import collections
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..monitor import stat_add


def _wrappers():
    """(module, wrapper) of every hand-written kernel, in the order of
    ``launch_counts``: B1, B2, B3, B4, B5, B6, B7."""
    from ..ops import flash_attention as fa
    from ..ops import flash_attention_bias as fab
    from ..ops import paged_attention as pa
    from ..ops import quant_ops as qo

    return ((fab, fab.flash_attention_bias), (fa, fa.flash_attention_fwd),
            (fa, fa.flash_attention_bwd_dq), (fa, fa.flash_attention_bwd_dkv),
            (pa, pa.paged_decode_attention), (pa, pa.paged_chunk_attention),
            (qo, qo.dequant_matmul))


def launch_counts() -> Tuple[int, ...]:
    return tuple(fn.launches for _mod, fn in _wrappers())


def add_launches(counts: Sequence[int], sign: int = 1) -> None:
    """Add (``sign`` -1: take back) per-wrapper launch counts, under
    each wrapper's own counter lock."""
    for (mod, fn), n in zip(_wrappers(), counts):
        if n:
            with mod._COUNT_LOCK:
                fn.launches += sign * n


# the tallies of the captures open now, by their streams' handles
_BY_STREAM = {}


def _stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def count_launch(fn, lock, device) -> None:
    """One launch of wrapper ``fn`` (its ``launches`` guarded by
    ``lock``) on ``device``'s current stream: counted, and credited to
    the capture recording that stream, if one is."""
    with lock:
        fn.launches += 1
    if _BY_STREAM:
        tally = _BY_STREAM.get(_stream_handle(device))
        if tally is not None:
            tally[fn] += 1


class StepGraph:
    """One step of fixed shapes: an eager warm-up, a capture, replays.

    Every capture is made in ``torch.cuda.graph``'s
    ``capture_error_mode="thread_local"`` (see the module's docstring)."""

    error_mode = "thread_local"

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: Tuple[int, ...] = ()

    def on_side_stream(self, fn: Callable):
        """``fn()`` on this step's stream, ordered after the work already
        queued on the current stream, and before the work queued on it
        later.  Every block ``fn`` allocates is freed back to the side
        stream's pool; the next use of that pool also waits for the
        current stream first, so no block is reused under a reader."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable, generators=()) -> None:
        """Record ``fn()`` into a graph on this step's stream; its
        return value is kept as ``outputs`` (tensors of the graph's
        private pool, rewritten by every replay).  Random draws from
        ``generators`` (a ``torch.Generator`` on the card each) advance
        with every replay; the default CUDA generator is registered by
        torch itself."""
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        tally = _BY_STREAM[self.stream.cuda_stream] = collections.Counter()
        raised = []

        def body():
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                raised.append(e)
                raise

        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode=self.error_mode):
                out = body()
        except BaseException:
            if raised:   # the step's own error names the op; the
                raise raised[0]   # capture's end only fails after it
            raise
        finally:
            del _BY_STREAM[self.stream.cuda_stream]
            # the capture ran nothing: its launches run at the replays
            add_launches([tally[fn] for _mod, fn in _wrappers()], sign=-1)
        self.launches = tuple(tally[fn] for _mod, fn in _wrappers())
        self.graph, self.outputs = graph, out
        stat_add("cuda_graph_captures")

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)
        stat_add("cuda_graph_replays")
