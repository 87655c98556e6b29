"""PyTorch port: ``paddle_tpu_torch.Model``'s static adapter (a Model
constructed under ``enable_static()`` with ``InputSpec`` inputs) on the
CPU.

- The JAX package's static adapter fails on any network with batch norm
  (its ``F.batch_norm`` writes a graph ``MeanOut`` into an eager buffer);
  the port's swaps the running statistics for persistable vars that the
  op updates in place.  So MobileNetV2 (``scale=0.25``, 3x32x32, the
  classifier's dropout at 0) is held to the port's dygraph adapter, which
  ``test_torch_hapi.py`` holds to the JAX package: from the same weights,
  ``eval_batch`` and ``predict_batch`` within 1e-5 (one float32 forward
  each, other op orders), ``train_batch``'s loss within 1e-4 relative
  and the running statistics after it within 1e-4 (batch norm's
  backward is the closed form in both, its forward one pass).
- The eval and predict programs hold no optimizer or gradient op, and
  every batch norm and dropout in them runs ``is_test``.
- ``predict``, ``evaluate`` and ``fit`` over ``io.DataLoader`` with 0
  and 2 workers: predictions and evaluate's loss within 1e-5 of the
  dygraph adapter's, fit's first step's loss within 1e-4.
- On a network without batch norm the port's static adapter trains like
  the JAX package's static adapter: 3 ``fit`` steps' losses within
  1e-5, evaluate and predict likewise.
- The capture path (the executor's ``StepGraph`` replaced by a stand-in
  that replays the recorded step, as ``test_torch_executor_graph.py``
  does): the train and eval programs capture (no ``capture_reason``),
  and a captured fit under ``CosineAnnealingDecay`` gives the uncaptured
  fit's losses exactly: the scheduler's rate reaches the graph, which
  the port writes into the Model's scope before each step (the JAX
  package's static optimizer writes it into the global scope).
- ``save`` after static training carries the trained parameters and
  running statistics; ``load`` pushes them into the scope.
- ``BenchmarkCallback``'s MFU in static mode comes from the executor's
  step timer: ``program_flops`` of the train program times the batch,
  which prices every convolution from shapes it infers (the 2.0 layers'
  graph outputs carry none): equal to the dygraph network's count.
"""
import numpy as np
import pytest
import torch

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, to_numpy)
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.hapi.model_stat import program_flops
from paddle_tpu_torch.observe import step_stats

FWD_RTOL, RTOL = 1e-5, 1e-4
BATCH = 8
rs = np.random.RandomState(31)
X = rs.randn(BATCH, 3, 32, 32).astype("f4")
Y = rs.randint(0, 10, (BATCH, 1)).astype("int64")


def _net(p, seed=0):
    p.seed(seed)
    net = p.vision.models.mobilenet_v2(scale=0.25, num_classes=10)
    net.classifier._sub_layers["0"].p = 0.0
    return net


def _prepare(p, m, lr=0.01, metrics=True):
    m.prepare(p.optimizer.Momentum(lr, 0.9, weight_decay=4e-5,
                                   parameters=m.parameters()),
              p.nn.CrossEntropyLoss(),
              p.metric.Accuracy(topk=(1, 5)) if metrics else None)
    return m


def _static(p, net, shape=(3, 32, 32), classes=10, **kw):
    p.enable_static()
    try:
        m = p.Model(net, inputs=[p.hapi.model.InputSpec(
            [None, *shape], "float32", "image")],
            labels=[p.hapi.model.InputSpec([None, 1], "int64", "label")])
        return _prepare(p, m, **kw)
    finally:
        p.disable_static()


def _weights(net):
    return {k: to_numpy(v) for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def init():
    return _weights(_net(T))


def _pair(init, **kw):
    dy = _prepare(T, T.Model(_net(T)), **kw)
    T.dygraph.state_dict_from_numpy(dy.network, init)
    net = _net(T)
    T.dygraph.state_dict_from_numpy(net, init)
    return dy, _static(T, net, **kw)


def test_static_batches_match_the_dygraph_adapter(init):
    dy, st = _pair(init)
    assert st._static_mode and not dy._static_mode
    assert_close(dy.predict_batch([X])[0], st.predict_batch([X])[0],
                 FWD_RTOL, "predict")
    want, got = dy.eval_batch([X], [Y]), st.eval_batch([X], [Y])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=FWD_RTOL)
    assert st._metrics[0].accumulate() == dy._metrics[0].accumulate()
    want, got = dy.train_batch([X], [Y]), st.train_batch([X], [Y])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    st._sync_scope_to_network()
    for (n, a), (_, b) in zip(dy.network.state_dict().items(),
                              st.network.state_dict().items()):
        if "_mean" in n or "_variance" in n:
            assert_close(to_numpy(a), to_numpy(b), RTOL, n)


def test_eval_and_predict_programs_are_test_mode_forwards(init):
    st = _pair(init)[1]._st
    train_types = {op.type for op in st["train"].global_block.ops}
    assert {"momentum", "batch_norm_grad", "dropout"} <= train_types
    for name in ("eval", "predict"):
        ops = st[name].global_block.ops
        assert not any(op.type == "momentum" or op.type.endswith("_grad")
                       for op in ops), name
        for op in ops:
            if op.type in ("batch_norm", "dropout"):
                assert op.attr("is_test") is True, (name, op.type)
            if op.type == "batch_norm":
                assert op.attr("use_global_stats") is True
    pred_ops = {op.type for op in st["predict"].global_block.ops}
    assert "softmax_with_cross_entropy" not in pred_ops
    assert st["pred_feed_names"] == ["image"]


def _loader(p, workers=0, n=24):
    io = p.io
    return io.DataLoader(
        p.vision.datasets.FakeData(num_samples=n, image_shape=(3, 32, 32),
                                   num_classes=10),
        batch_sampler=io.BatchSampler(io.RandomSampler(
            list(range(n)), generator=5), batch_size=BATCH, drop_last=True),
        num_workers=workers)


class _Losses(T.hapi.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"])


@pytest.mark.parametrize("workers", [0, 2])
def test_evaluate_predict_fit_over_the_loader(init, workers):
    dy, st = _pair(init)
    want = dy.predict(_loader(T, n=16), stack_outputs=True)[0]
    preds = st.predict(_loader(T, workers, n=16), stack_outputs=True)[0]
    assert preds.shape == (16, 10)
    assert_close(want, preds, FWD_RTOL)
    want = dy.evaluate(_loader(T, n=16), verbose=0)
    logs = st.evaluate(_loader(T, workers, n=16), verbose=0)
    assert sorted(logs) == ["acc_top1", "acc_top5", "loss"]
    np.testing.assert_allclose(logs["loss"], want["loss"], rtol=FWD_RTOL)
    assert logs["acc_top5"] == want["acc_top5"]
    x, y = next(iter(_loader(T)))
    first = dy.train_batch([x], [y])["loss"]
    rec = _Losses()
    st.fit(_loader(T, workers), epochs=1, verbose=0, callbacks=[rec])
    assert len(rec.losses) == 3 and np.isfinite(rec.losses).all()
    np.testing.assert_allclose(rec.losses[0], first, rtol=RTOL)


def _plain_net(p):
    p.seed(5)
    return p.nn.Sequential(
        p.nn.Conv2D(3, 4, 3, padding=1), p.nn.ReLU(), p.nn.MaxPool2D(2, 2),
        p.nn.Flatten(), p.nn.Linear(4 * 4 * 4, 10))


def test_static_adapter_without_batch_norm_matches_jax():
    jnet = _plain_net(J)
    tnet = _plain_net(T)
    T.dygraph.state_dict_from_numpy(tnet, _weights(jnet))
    losses, evals, preds = [], [], []
    for p, net in ((J, jnet), (T, tnet)):
        m = _static(p, net, shape=(3, 8, 8), lr=0.05)
        rec = _Losses() if p is T else _jax_losses()
        data = p.vision.datasets.FakeData(num_samples=24,
                                          image_shape=(3, 8, 8),
                                          num_classes=10)
        m.fit(data, epochs=1, batch_size=8, shuffle=False, verbose=0,
              callbacks=[rec])
        losses.append(rec.losses)
        evals.append(m.evaluate(data, batch_size=8, verbose=0))
        preds.append(m.predict(data, batch_size=8, stack_outputs=True)[0])
    np.testing.assert_allclose(losses[1], losses[0], rtol=FWD_RTOL)
    np.testing.assert_allclose(evals[1]["loss"], evals[0]["loss"],
                               rtol=FWD_RTOL)
    assert evals[1]["acc_top1"] == evals[0]["acc_top1"]
    assert_close(preds[0], preds[1], FWD_RTOL)


def _jax_losses():
    class Losses(J.hapi.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    return Losses()


def test_jax_static_adapter_fails_on_batch_norm():
    J.enable_static()
    try:
        net = J.nn.Sequential(J.nn.Conv2D(3, 4, 3), J.nn.BatchNorm2D(4))
        m = J.Model(net, inputs=[J.hapi.model.InputSpec(
            [None, 3, 6, 6], "float32", "image")])
        with pytest.raises(AttributeError, match="_value"):
            m.prepare()
    finally:
        J.disable_static()


class _RecordedStep:
    """``StepGraph``'s contract without a card: ``capture`` records the
    step without running it, each ``replay`` runs what was recorded."""

    def __init__(self, device, error_mode="global"):
        self.graph, self.outputs, self.launches = None, None, ()

    def on_side_stream(self, fn):
        return fn()

    def capture(self, fn, generators=()):
        self.graph, self._fn = True, fn

    def replay(self):
        self.outputs = self._fn()


def test_captured_fit_follows_the_lr_schedule(init, monkeypatch):
    monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    runs = []
    for captured in (False, True):
        net = _net(T)
        T.dygraph.state_dict_from_numpy(net, init)
        T.enable_static()
        try:
            m = T.Model(net, inputs=[T.InputSpec([None, 3, 32, 32],
                                                 "float32", "image")],
                        labels=[T.InputSpec([None, 1], "int64", "label")])
            sched = T.optimizer.lr.CosineAnnealingDecay(0.05, T_max=3)
            m.prepare(T.optimizer.Momentum(sched, 0.9,
                                           parameters=m.parameters()),
                      T.nn.CrossEntropyLoss())
        finally:
            T.disable_static()
        m._st["exe"]._captures = captured
        rec = _Losses()
        m.fit(_loader(T), epochs=1, verbose=0,
              callbacks=[rec, T.callbacks.LRScheduler()])
        m.evaluate(_loader(T, n=16), verbose=0)
        m.evaluate(_loader(T, n=16), verbose=0)
        st = m._st
        # the rate of the last step (the scheduler stepped once after it)
        lr = st["scope"].get_var(st["lr_var"].name)
        assert sched.last_epoch == 3 and float(lr.reshape(-1)[0]) == \
            pytest.approx(0.05 * (1 + np.cos(np.pi * 2 / 3)) / 2)
        runs.append(rec.losses)
        if captured:
            # the train and eval programs' entries (the startup ran once)
            stepped = [e for e in st["exe"]._cache.values() if e.runs >= 2]
            assert len(stepped) == 2
            assert all(e.eager_reason is None and e.graph is not None
                       for e in stepped)
    assert runs[0] == runs[1]


def test_save_after_static_training_and_load_into_both_adapters(
        init, tmp_path):
    dy, st = _pair(init)
    st.train_batch([X], [Y])
    st.save(str(tmp_path / "m"))
    want = st.predict_batch([X])[0]
    dy.load(str(tmp_path / "m"))
    assert_close(want, dy.predict_batch([X])[0], FWD_RTOL)
    fresh = _pair(init)[1]
    fresh.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(want, fresh.predict_batch([X])[0])


def test_benchmark_mfu_from_the_step_timer(init):
    st = _pair(init)[1]
    step_stats.reset_step_stats()
    bench = T.callbacks.BenchmarkCallback(batch_size=BATCH,
                                          peak_tflops=1e-6)
    st.fit(_loader(T), epochs=1, verbose=0, callbacks=[bench])
    timer = step_stats.step_timer().summary(1e-6)
    flops = program_flops(st._st["train"]) * BATCH
    assert timer["compiles"] == 1 and timer["steps"] == 2
    assert timer["flops_per_step"] == int(flops)
    assert timer["examples_per_sec"] > 0
    assert bench.last_summary["mfu"] == timer["mfu"] > 0
    with torch.no_grad():
        assert T.flops(st._st["train"]) == program_flops(st._st["train"])


def test_program_flops_count_every_convolution(init):
    """The static programs' convolutions are priced from inferred shapes
    (the 2.0 layers' graph outputs carry none): the predict program's
    conv FLOPs a sample equal the dygraph network's, counted from each
    convolution's output on a real forward."""
    st = _pair(init)[1]
    net = _net(T)
    want = []

    def count(layer, inputs, out):
        want.append(2 * int(np.prod(out.shape[1:])) *
                    int(np.prod(layer.weight.shape[1:])))

    for layer in net.sublayers():
        if isinstance(layer, T.nn.Conv2D):
            layer.register_forward_post_hook(count)
    net.eval()
    net(T.to_tensor(X[:1]))
    total, per_type = program_flops(st._st["predict"], detail=True)
    assert len(want) == 52 and per_type["conv2d"] == sum(want)
    train = program_flops(st._st["train"], detail=True)[1]
    assert train["conv2d"] == sum(want) and \
        train["conv2d_grad"] == 2 * sum(want)
