"""PyTorch port: dygraph ResNet (``vision/models/resnet.py``) trained
against the JAX package's dygraph, on the CPU.

- ``ResNet(BasicBlock, [1, 1, 1, 1], num_classes=10)`` at 3x32x32, built
  once by each package (the JAX build and its first step take about half
  a minute here: eager per-op compiles), the JAX weights carried across
  (``dygraph.state_dict_from_numpy``), trained 3 steps with
  ``optimizer.Momentum(0.1, 0.9)`` and ``F.cross_entropy`` on one seeded
  batch of 8: the losses within 1e-4 relative, every parameter and
  running statistic within 1e-4 of its tensor's largest magnitude, as
  the static ResNet test holds them (float32 both sides, other summation
  orders, which batch norm over few values and 3 steps amplify; measured
  about 2e-5).  A batch of 8, not 2: at 32x32 the last stage's batch norm
  sees one value a sample, and over 2 values its output is +-1 and its
  gradient scales with 1 / |a - b|, so two float32 runs of the same
  network part within a step whatever the code (the JAX package against
  itself, its image moved by one ulp, parts likewise).
- After each step the running statistics hold no autograd graph
  (``grad_fn`` None): a buffer that kept the graph would keep every
  step's activations alive.
- ``resnet50()``: the state dict keys equal the JAX package's (267: 161
  parameters, 106 running statistics).  Building the JAX model takes
  seconds, so no forward runs.
- bf16 ``auto_cast`` on the small ResNet (the port alone): finite losses,
  each within 2**-4 of the float32 run's first loss from the float32
  run's (every convolution rounds to bfloat16 through 4 blocks and 3
  steps; the loss falls from about 3 to about 0.02 in these steps, so the
  gap is held to the loss's scale, not to each later loss), float32
  gradients on the float32 parameters.
- Without a card the default place raises.
"""
import numpy as np
import pytest
import torch

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, to_numpy)

RTOL = 1e-4
AMP_LOSS_RTOL = 2.0 ** -4
BATCH, STEPS = 8, 3


def _small(p):
    from importlib import import_module

    m = import_module(p.__name__ + ".vision.models.resnet")
    return m.ResNet(m.BasicBlock, [1, 1, 1, 1], num_classes=10)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's model, its initial weights and its 3 steps."""
    J.seed(0)
    model = _small(J)
    init = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    opt = J.optimizer.Momentum(0.1, 0.9, parameters=model.parameters())
    x, y = _batch()
    losses = []
    for _ in range(STEPS):
        loss = J.nn.functional.cross_entropy(model(J.to_tensor(x)),
                                             J.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    final = {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}
    return init, losses, final


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randn(BATCH, 3, 32, 32).astype("f4"),
            rs.randint(0, 10, (BATCH, 1)).astype("int64"))


def _train(init, amp=False):
    model = _small(T)
    T.dygraph.state_dict_from_numpy(model, init)
    opt = T.optimizer.Momentum(0.1, 0.9, parameters=model.parameters())
    x, y = _batch()
    losses, grads_f32 = [], True
    for _ in range(STEPS):
        with T.amp.auto_cast(enable=amp, dtype="bfloat16"):
            loss = T.nn.functional.cross_entropy(model(T.to_tensor(x)),
                                                 T.to_tensor(y))
        loss.backward()
        grads_f32 &= all(p.grad.dtype == torch.float32
                         for p in model.parameters())
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        assert all(b._value.grad_fn is None and not b._value.requires_grad
                   for b in model.buffers())
    return model, losses, grads_f32


def test_small_resnet_trains_like_jax(jax_run):
    init, want_losses, want = jax_run
    model, losses, _ = _train(init)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
    got = {k: to_numpy(v) for k, v in model.state_dict().items()}
    assert list(got) == list(want)
    for k in want:
        assert_close(want[k], got[k], RTOL, k)


def test_small_resnet_bf16_auto_cast(jax_run):
    init = jax_run[0]
    _, f32_losses, _ = _train(init)
    _, amp_losses, grads_f32 = _train(init, amp=True)
    assert np.all(np.isfinite(amp_losses))
    np.testing.assert_allclose(amp_losses, f32_losses,
                               atol=AMP_LOSS_RTOL * f32_losses[0])
    assert grads_f32


def test_resnet50_state_dict_keys_match_jax():
    jm, tm = J.vision.models.resnet50(), T.vision.models.resnet50()
    jkeys, tkeys = list(jm.state_dict()), list(tm.state_dict())
    assert jkeys == tkeys and len(tkeys) == 267
    assert len(tm.parameters()) == 161 and len(tm.buffers()) == 106
    for (n, a), b in zip(jm.state_dict().items(), tm.state_dict().values()):
        assert tuple(a.shape) == tuple(b.shape), n


def test_default_place_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from paddle_tpu_torch.dygraph import base

    prev = base._state.place
    base._state.place = "gpu:0"
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.vision.models.resnet18()
    finally:
        base._state.place = prev
