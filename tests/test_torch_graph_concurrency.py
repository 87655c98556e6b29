"""PyTorch port: CUDA-graph capture beside other threads' CUDA work
(``framework/graphs.py``), without a card.

- Launch counts.  While a capture is open, each kernel wrapper credits
  its launch to the capture whose stream it was enqueued on: the
  capturing thread's launches, and another thread's launches on the
  capture's stream (the autograd engine's worker running a backward
  inside an executor capture).  A second thread launching on a stream of
  its own inside the window (a decode replica), or the capturing thread
  on another stream, is counted once, as it ran, and never credited to
  the capture's replays.  Here the launches
  are ``graphs.count_launch`` calls, the streams stand-in handles, and
  ``torch.cuda.graph`` a stand-in that records its ``capture_error_mode``.
- The capture mode.  Every capture, the executor's compiled step
  included, is made in ``"thread_local"`` mode, so a capture on one
  thread does not make another thread's synchronizing or allocating CUDA
  calls fail.  ``chip_smoke.py``'s ``capture_concurrency`` phase runs
  both on the card.
"""
import contextlib
import threading
import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpkg
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import graphs
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_attention_bias as fab
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_ops as qo

CAPTURE_STREAM, REPLICA_STREAM = 111, 222
B3, B5, B6 = 2, 4, 5       # places in graphs.launch_counts()


class _FakeGraph:
    replays = 0

    def register_generator_state(self, gen):
        pass

    def replay(self):
        _FakeGraph.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph pieces as stand-ins; the current stream of
    each thread is ``streams.h``.  Yields the capture modes asked for."""
    modes, streams = [], threading.local()

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode="global", pool=None):
        modes.append(capture_error_mode)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(graphs, "_stream_handle",
                        lambda device: getattr(streams, "h", 0))
    fab.reset_launch_count()
    fa.reset_launch_counts()
    pa.reset_launch_counts()
    qo.reset_launch_count()
    yield modes, streams
    fab.reset_launch_count()
    fa.reset_launch_counts()
    pa.reset_launch_counts()
    qo.reset_launch_count()


def _launch(fn, lock, n=1):
    for _ in range(n):
        graphs.count_launch(fn, lock, torch.device("cpu"))


def _step():
    step = graphs.StepGraph.__new__(graphs.StepGraph)
    step.device = torch.device("cpu")
    step.stream = types.SimpleNamespace(cuda_stream=CAPTURE_STREAM)
    step.graph, step.outputs, step.launches = None, None, ()
    return step


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def test_capture_credits_only_the_launches_it_records(fake_cuda):
    """In the capture window: the capturing thread launches B5 twice; a
    replica's thread launches B5 three times and B6 once on its own
    stream; an autograd worker launches B3 once on the capture's
    stream.  The capture keeps B5 x2 and B3 x1; the replica's launches
    stay counted once; each replay adds the capture's."""
    modes, streams = fake_cuda

    def replica():
        streams.h = REPLICA_STREAM
        _launch(pa.paged_decode_attention, pa._COUNT_LOCK, 3)
        _launch(pa.paged_chunk_attention, pa._COUNT_LOCK)

    def autograd_worker():
        streams.h = CAPTURE_STREAM
        _launch(fa.flash_attention_bwd_dq, fab._COUNT_LOCK)

    def body():
        streams.h = CAPTURE_STREAM
        _launch(pa.paged_decode_attention, pa._COUNT_LOCK, 2)
        _in_thread(replica)
        _in_thread(autograd_worker)
        return "outputs"

    step = _step()
    step.capture(body)
    assert modes == ["thread_local"]
    want = [0] * 7
    want[B5], want[B3] = 2, 1
    assert list(step.launches) == want
    after = [0] * 7
    after[B5], after[B6] = 3, 1          # the replica's, as they ran
    assert list(graphs.launch_counts()) == after
    step.replay()
    step.replay()
    after[B5] += 4
    after[B3] += 2
    assert list(graphs.launch_counts()) == after
    assert step.outputs == "outputs"
    # a launch after the capture closed is nobody's
    streams.h = CAPTURE_STREAM
    _launch(pa.paged_decode_attention, pa._COUNT_LOCK)
    assert graphs._BY_STREAM == {}
    assert graphs.launch_counts()[B5] == after[B5] + 1


def test_two_concurrent_captures_keep_their_own_counts(fake_cuda):
    """Two captures open at once on two threads (two decode replicas'
    first captures): each keeps exactly its own launches."""
    modes, streams = fake_cuda
    inside, go = threading.Barrier(2), threading.Event()
    steps = [_step(), _step()]
    steps[1].stream = types.SimpleNamespace(cuda_stream=REPLICA_STREAM)

    def body(i, n):
        def run():
            streams.h = steps[i].stream.cuda_stream
            inside.wait()            # both captures are open now
            _launch(pa.paged_decode_attention, pa._COUNT_LOCK, n)
            _launch(pa.paged_chunk_attention, pa._COUNT_LOCK, i)
            inside.wait()
        return run

    threads = [threading.Thread(target=lambda i=i, n=n: steps[i].capture(
        body(i, n))) for i, n in ((0, 2), (1, 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert steps[0].launches[B5] == 2 and steps[0].launches[B6] == 0
    assert steps[1].launches[B5] == 5 and steps[1].launches[B6] == 1
    assert list(graphs.launch_counts()) == [0] * 7
    assert modes == ["thread_local"] * 2


def test_a_failed_capture_takes_its_launches_back(fake_cuda):
    _modes, streams = fake_cuda

    def body():
        streams.h = CAPTURE_STREAM
        _launch(qo.dequant_matmul, qo._COUNT_LOCK, 3)
        raise ValueError("op 7 failed")

    step = _step()
    with pytest.raises(ValueError, match="op 7"):
        step.capture(body)
    assert list(graphs.launch_counts()) == [0] * 7
    assert graphs._BY_STREAM == {}


def test_a_launch_off_the_capture_stream_is_not_credited(fake_cuda):
    """The capturing thread launches B6 once on another stream inside the
    window (work the graph does not record): it counts once, as it ran,
    and the replays add only the capture's B5."""
    _modes, streams = fake_cuda

    def body():
        streams.h = CAPTURE_STREAM
        _launch(pa.paged_decode_attention, pa._COUNT_LOCK)
        streams.h = REPLICA_STREAM
        _launch(pa.paged_chunk_attention, pa._COUNT_LOCK)
        streams.h = CAPTURE_STREAM

    step = _step()
    step.capture(body)
    want = [0] * 7
    want[B5] = 1
    assert list(step.launches) == want
    step.replay()
    after = [0] * 7
    after[B5], after[B6] = 1, 1
    assert list(graphs.launch_counts()) == after


class _CpuStep(graphs.StepGraph):
    """The real ``StepGraph`` over the CPU: its stream a stand-in, its
    side stream the current one."""

    made = []

    def __init__(self, device):
        self.device = device
        self.stream = types.SimpleNamespace(cuda_stream=CAPTURE_STREAM)
        self.graph, self.outputs, self.launches = None, None, ()
        _CpuStep.made.append(self)

    def on_side_stream(self, fn):
        return fn()


def test_the_executor_captures_in_thread_local_mode(fake_cuda, monkeypatch):
    """The executor's compiled step through the real ``StepGraph.capture``:
    the warm-up, then the capture, asked for in ``"thread_local"`` mode,
    and its result equal to an eager run's."""
    modes, _streams = fake_cuda
    monkeypatch.setattr(texecutor, "StepGraph", _CpuStep)
    main, startup = tprogram.Program(), tprogram.Program()
    with tunique.guard(), tprogram.program_guard(main, startup):
        x = tlayers.data("x", [4])
        loss = tlayers.mean(tlayers.fc(x, 3, act="relu"))
    feed = {"x": np.random.RandomState(0).rand(2, 4).astype("f4")}
    eager = tpkg.Executor(tpkg.CPUPlace())
    scope = tpkg.framework.Scope()
    eager.run(startup, scope=scope)
    want = eager.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
    exe = tpkg.Executor(tpkg.CPUPlace())
    exe._captures = True
    got = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
           for _ in range(2)]
    assert modes == ["thread_local"]
    assert _CpuStep.made and all(s.error_mode == "thread_local"
                                 for s in _CpuStep.made)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)


def test_every_capture_is_thread_local():
    """Both users (the executor and the decode engine) make their graphs
    as ``StepGraph(device)``: the class fixes the mode."""
    from paddle_tpu_torch.serving import decode

    assert graphs.StepGraph.error_mode == "thread_local"
    assert decode.StepGraph is graphs.StepGraph
    assert texecutor.StepGraph is graphs.StepGraph
