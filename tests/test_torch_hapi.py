"""PyTorch port: ``paddle_tpu_torch.Model`` (``hapi/model.py``) in dygraph
mode, its callbacks and ``model_stat``, against the JAX package's
``paddle_tpu.Model``, on the CPU.

- ``mobilenet_v2(scale=0.25, num_classes=10)`` at 3x32x32, the
  classifier's dropout set to 0 on both sides, built once by each
  package (the JAX build and first step take about a minute here: eager
  per-op compiles), the JAX weights carried across by ``state_dict``,
  prepared with ``Momentum(0.01, 0.9, weight_decay=4e-5)``,
  ``CrossEntropyLoss`` and ``Accuracy(topk=(1, 5))``.  ``eval_batch``
  and ``predict_batch`` (batch 8) within 1e-5 (forwards only), the
  metric equal; then one ``train_batch``: the loss within 1e-4 relative
  (the ResNet tests' tolerance; measured 1.7e-5), the metric equal, the
  step's update within ``UPDATE_TOL`` and 4x the port's own gap for an
  image nudged by about one ulp (the gradient's float32 sensitivity).
- ``evaluate``, ``predict`` and ``fit`` over ``io.DataLoader`` with 0 and
  with 2 worker processes, the JAX package's batches in its order:
  evaluate's loss and predictions within 1e-5, its top-1 / top-5 equal;
  fit's first step's loss within 1e-4 (the trajectories part after it,
  as float32 batch-norm training does: ``PERF.md`` section 6).
- ``save`` / ``load`` both ways: a ``.pdparams`` written by either
  package loads into the other's ``Model`` and predicts the same; the
  port's ``.pdopt`` restores its optimizer (training resumes exactly).
- ``EarlyStopping`` stops as the JAX package's does; ``LRScheduler``
  steps the scheduler per batch; ``BenchmarkCallback`` reports steps,
  examples/s and an MFU from ``flops_per_step``.
- A batch already on the device reaches ``to_variable`` as a tensor.
- The later-slice features raise ``NotImplementedError`` naming their
  ROADMAP Queue A item: ``save(training=False)``, ``flops(layer)`` and
  ``summary(layer, input_size=...)`` (item 6); ``ModelCheckpoint``'s
  default route (item 4) is ported and commits a step an epoch.
"""
import numpy as np
import pytest
import torch

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, pair, to_numpy)
from paddle_tpu_torch.framework import unique_name

FWD_RTOL, RTOL = 1e-5, 1e-4
# One training step's update (parameters and running statistics, all
# together): MobileNetV2's float32 gradient at this random init moves by
# about as much for an image nudged by 1e-7 relative as between the two
# packages (the first layers' weights part by 1.04e-4 after the step;
# ResNet-50's gradient shows the same sensitivity on the card, PERF.md),
# and the fit trajectories part after step 1 (2e-4 at step 2, 2.8 % at
# step 3).
# So step 1's loss is held to 1e-4, and its update to 0.1 and 4x the
# port's own gap for the nudge; forwards (evaluate, predict) to 1e-5.
UPDATE_TOL, UPDATE_SELF_FACTOR = 0.1, 4.0
BATCH = 8
rs = np.random.RandomState(21)
X1 = rs.randn(BATCH, 3, 32, 32).astype("f4")
Y1 = rs.randint(0, 10, (BATCH, 1)).astype("int64")
X2 = rs.randn(BATCH, 3, 32, 32).astype("f4")
Y2 = rs.randint(0, 10, (BATCH, 1)).astype("int64")


def _net(p):
    p.seed(0)
    net = p.vision.models.mobilenet_v2(scale=0.25, num_classes=10)
    net.classifier._sub_layers["0"].p = 0.0
    return net


def _model(p, net, lr=0.01):
    m = p.Model(net)
    m.prepare(p.optimizer.Momentum(lr, 0.9, weight_decay=4e-5,
                                   parameters=m.parameters()),
              p.nn.CrossEntropyLoss(), p.metric.Accuracy(topk=(1, 5)))
    return m


def _fake(p, n=24, seed=0):
    return p.vision.datasets.FakeData(num_samples=n, image_shape=(3, 32, 32),
                                      num_classes=10, seed=seed)


def _loader(p, workers=0, n=24):
    io = p.io
    return io.DataLoader(_fake(p, n), batch_sampler=io.BatchSampler(
        io.RandomSampler(list(range(n)), generator=5), batch_size=BATCH,
        drop_last=True), num_workers=workers)


def _state(m):
    return {k: to_numpy(v) for k, v in m.network.state_dict().items()}


def _loss_recorder(p):
    class Losses(p.hapi.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    return Losses()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's model: its initial weights, eval_batch and
    predict_batch from them, one train_batch, then a fresh model from the same
    weights through evaluate / predict / fit over its loader."""
    jm = _model(J, _net(J))
    init = _state(jm)
    out = {"init": init, "eval": jm.eval_batch([X2], [Y2]),
           "eval_acc": jm._metrics[0].accumulate(),
           "predict": jm.predict_batch([X2])[0]}
    jm._metrics[0].reset()
    out["train"] = jm.train_batch([X1], [Y1])
    out["train_acc"] = jm._metrics[0].accumulate()
    out["after"] = _state(jm)
    fm = J.Model(_net(J))
    fm.network.set_state_dict(init)
    fm.prepare(J.optimizer.Momentum(0.01, 0.9, weight_decay=4e-5,
                                    parameters=fm.parameters()),
               J.nn.CrossEntropyLoss(), J.metric.Accuracy(topk=(1, 5)))
    out["evaluate"] = fm.evaluate(_loader(J, n=16), verbose=0)
    out["predict_all"] = fm.predict(_loader(J, n=16), stack_outputs=True)[0]
    rec = _loss_recorder(J)
    fm.fit(_loader(J), epochs=1, verbose=0, callbacks=[rec])
    out["fit_losses"] = rec.losses
    out["jax_model"] = fm
    return out


def _port_model(init, lr=0.01):
    m = _model(T, _net(T), lr)
    T.dygraph.state_dict_from_numpy(m.network, init)
    return m


def _update_gap(init, a, b):
    """||(a - init) - (b - init)|| / ||a - init|| over every parameter
    and running statistic together: how far two steps' updates part."""
    da = np.concatenate([(a[k] - init[k]).ravel() for k in init])
    db = np.concatenate([(b[k] - init[k]).ravel() for k in init])
    return float(np.linalg.norm(da - db) / np.linalg.norm(da))


def test_eval_predict_train_batch_match_jax(jax_run):
    init = jax_run["init"]
    m = _port_model(init)
    logs = m.eval_batch([X2], [Y2])
    np.testing.assert_allclose(logs["loss"], jax_run["eval"]["loss"],
                               rtol=FWD_RTOL)
    assert m._metrics[0].accumulate() == jax_run["eval_acc"]
    assert_close(jax_run["predict"], m.predict_batch([X2])[0], FWD_RTOL)
    m._metrics[0].reset()
    logs = m.train_batch([X1], [Y1])
    np.testing.assert_allclose(logs["loss"], jax_run["train"]["loss"],
                               rtol=RTOL)
    assert m._metrics[0].accumulate() == jax_run["train_acc"]
    gap = _update_gap(init, jax_run["after"], _state(m))
    if gap > RTOL:
        # the port against itself from the same weights, its image moved
        # by 1e-7 relative (about one ulp): the step's own sensitivity
        nudged = _port_model(init)
        nudged.train_batch([(X1 * (1 + 1e-7 * np.random.RandomState(1).randn(
            *X1.shape))).astype("f4")], [Y1])
        own = _update_gap(init, _state(m), _state(nudged))
        assert gap <= min(UPDATE_TOL, UPDATE_SELF_FACTOR * own), (gap, own)


@pytest.mark.parametrize("workers", [0, 2])
def test_evaluate_predict_fit_over_the_loader_match_jax(jax_run, workers):
    m = _port_model(jax_run["init"])
    logs = m.evaluate(_loader(T, workers, n=16), verbose=0)
    want = jax_run["evaluate"]
    assert sorted(logs) == sorted(want) == ["acc_top1", "acc_top5", "loss"]
    np.testing.assert_allclose(logs["loss"], want["loss"], rtol=FWD_RTOL)
    assert [logs["acc_top1"], logs["acc_top5"]] == \
        [want["acc_top1"], want["acc_top5"]]
    preds = m.predict(_loader(T, workers, n=16), stack_outputs=True)[0]
    assert preds.shape == (16, 10)
    assert_close(jax_run["predict_all"], preds, FWD_RTOL)
    rec = _loss_recorder(T)
    hist = m.fit(_loader(T, workers), epochs=1, verbose=0, callbacks=[rec])
    assert len(rec.losses) == len(jax_run["fit_losses"]) == 3
    assert np.isfinite(rec.losses).all() and hist["loss"] == [rec.losses[-1]]
    # step 1 from the same weights; the trajectories part after it
    np.testing.assert_allclose(rec.losses[0], jax_run["fit_losses"][0],
                               rtol=RTOL)


def test_save_and_load_cross_between_the_packages(jax_run, tmp_path):
    jm = jax_run["jax_model"]
    jm.save(str(tmp_path / "jax"))
    tm = _port_model(jax_run["init"])
    tm.load(str(tmp_path / "jax"), reset_optimizer=True)
    want = to_numpy(jm.predict_batch([X1])[0])
    assert_close(want, tm.predict_batch([X1])[0], RTOL)
    tm.train_batch([X2], [Y2])
    tm.save(str(tmp_path / "port"))
    jm.load(str(tmp_path / "port"), reset_optimizer=True)
    assert_close(tm.predict_batch([X1])[0],
                 to_numpy(jm.predict_batch([X1])[0]), RTOL)


def _mlp(p):
    p.seed(7)
    return p.nn.Sequential(p.nn.Flatten(), p.nn.Linear(12, 16), p.nn.ReLU(),
                           p.nn.Linear(16, 4))


def _tiny_data(p, n=32, seed=0):
    return p.vision.datasets.FakeData(num_samples=n, image_shape=(3, 2, 2),
                                      num_classes=4, seed=seed)


def test_optimizer_state_round_trip_resumes_exactly(tmp_path):
    x = rs.randn(8, 3, 2, 2).astype("f4")
    y = rs.randint(0, 4, (8, 1)).astype("int64")

    def model():
        with unique_name.guard():   # the optimizer's state is by name
            m = T.Model(_mlp(T))
        m.prepare(T.optimizer.Momentum(0.1, 0.9, parameters=m.parameters()),
                  T.nn.CrossEntropyLoss())
        return m

    a = model()
    a.train_batch([x], [y])
    a.save(str(tmp_path / "a"))
    b = model()
    b.load(str(tmp_path / "a"))
    for m in (a, b):
        m.train_batch([x], [y])
    for k, v in _state(a).items():
        np.testing.assert_array_equal(v, _state(b)[k])


def test_early_stopping_stops_like_jax():
    epochs = []
    for p in (J, T):
        m = p.Model(_mlp(p))
        m.prepare(p.optimizer.Adam(0.0, parameters=m.parameters()),
                  p.nn.CrossEntropyLoss())
        es = p.hapi.callbacks.EarlyStopping(monitor="loss", patience=1,
                                            mode="min")
        hist = m.fit(_tiny_data(p), eval_data=_tiny_data(p, 16, 1),
                     epochs=10, batch_size=16, verbose=0, callbacks=[es])
        epochs.append(len(hist["loss"]))
    assert epochs[1] == epochs[0] < 10


def test_lr_scheduler_and_benchmark_callbacks():
    m = T.Model(_mlp(T))
    sched = T.optimizer.lr.CosineAnnealingDecay(0.1, T_max=4)
    m.prepare(T.optimizer.Momentum(sched, 0.9, parameters=m.parameters()),
              T.nn.CrossEntropyLoss())
    bench = T.callbacks.BenchmarkCallback(batch_size=8, flops_per_step=1e6,
                                          peak_tflops=1e-6)
    m.fit(_tiny_data(T), epochs=1, batch_size=8, verbose=0,
          callbacks=[T.callbacks.LRScheduler(), bench])
    assert sched.last_epoch == 4 and sched.last_lr == pytest.approx(0.0)
    s = bench.last_summary
    assert s["steps"] == 4 and s["examples_per_sec"] > 0
    assert s["mfu"] == pytest.approx(
        1e6 / (1e-6 * 1e12) * s["steps_per_sec"], rel=1e-3)


def test_device_batches_reach_to_variable_as_tensors(monkeypatch):
    from paddle_tpu_torch.hapi import model as hapi_model

    seen = []
    real = hapi_model.to_variable

    def to_variable(value):
        seen.append(type(value))
        return real(value)

    monkeypatch.setattr(hapi_model, "to_variable", to_variable)
    m = T.Model(_mlp(T))
    m.prepare(T.optimizer.SGD(0.1, parameters=m.parameters()),
              T.nn.CrossEntropyLoss())
    x = torch.from_numpy(rs.randn(4, 3, 2, 2).astype("f4"))
    m.train_batch([x], [torch.zeros(4, 1, dtype=torch.int64)])
    m.train_batch([x.numpy()], [np.zeros((4, 1), "int64")])
    assert seen == [torch.Tensor, torch.Tensor, np.ndarray, np.ndarray]


def test_later_slice_features_raise_naming_their_item(tmp_path):
    m = T.Model(_mlp(T))
    m.prepare(T.optimizer.SGD(0.1, parameters=m.parameters()),
              T.nn.CrossEntropyLoss())
    # ModelCheckpoint's default route (Queue A item 4) is ported: fit's
    # save_dir commits a checkpoint step an epoch
    m.fit(_tiny_data(T), batch_size=8, verbose=0, save_dir=str(tmp_path))
    assert (tmp_path / "step_0" / "MANIFEST.json").is_file()
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        m.save(str(tmp_path / "infer"), training=False)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        T.flops(m.network, input_size=(2, 3, 2, 2))
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        T.summary(m.network, input_size=(2, 3, 2, 2))
    stats = m.summary()
    assert stats["total_params"] == 12 * 16 + 16 + 16 * 4 + 4


def test_legacy_model_checkpoint_saves_and_restores(tmp_path):
    m = T.Model(_mlp(T))
    m.prepare(T.optimizer.SGD(0.1, parameters=m.parameters()),
              T.nn.CrossEntropyLoss())
    ckpt = T.callbacks.ModelCheckpoint(save_dir=str(tmp_path),
                                       legacy_format=True)
    m.fit(_tiny_data(T), epochs=2, batch_size=8, verbose=0, callbacks=[ckpt])
    assert sorted(f.name for f in tmp_path.iterdir()) == \
        ["0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
         "final.pdparams"]
    fresh = T.Model(_mlp(T))
    fresh.prepare(T.optimizer.SGD(0.1, parameters=fresh.parameters()),
                  T.nn.CrossEntropyLoss())
    assert ckpt.restore_latest(fresh) == 1
    for k, v in _state(m).items():
        np.testing.assert_array_equal(v, _state(fresh)[k])
