"""PyTorch port: gradient clipping (``nn/clip.py``) and ``nn.utils``
(weight and spectral norm, parameter vectors) against the JAX package's,
on the CPU.

- Each ``ClipGradBy*`` in an ``SGD`` step: a small network built by both
  packages, the JAX weights carried across by ``state_dict``, 3 steps
  with bounds that clip; every parameter within 1e-5 of its tensor's
  largest magnitude (float32 both sides, other summation orders).
- ``weight_norm`` (dim 0, and the whole tensor) and ``spectral_norm`` on
  ``Linear`` and ``Conv2D``: the state dict keys equal the JAX package's
  (``weight_g``/``weight_v``; ``weight_orig`` and the buffer
  ``weight_u``), so weights cross by key; the forward over 3 calls (the
  power iteration moving ``u``) and the factors' gradients within 1e-5
  relative; ``spectral_norm``'s start vector is numpy
  ``RandomState(0)``'s in both, so ``u`` agrees after each call;
  ``remove_weight_norm`` bakes the same weight.
- ``parameters_to_vector`` / ``vector_to_parameters`` round-trip and
  equal the JAX package's vector.
"""
import numpy as np
import pytest

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, pair, to_numpy)

RTOL = 1e-5
rs = np.random.RandomState(9)
VEC = (3.0 * rs.randn(5, 6)).astype("f4")
IMG = rs.randn(2, 3, 6, 6).astype("f4")


def _net(p):
    p.seed(1)
    return p.nn.Sequential(p.nn.Linear(6, 8), p.nn.Tanh(), p.nn.Linear(8, 3))


@pytest.mark.parametrize("make_clip", [
    lambda p: p.nn.ClipGradByValue(0.05),
    lambda p: p.nn.ClipGradByValue(0.1, min=-0.02),
    lambda p: p.nn.ClipGradByNorm(0.1),
    lambda p: p.nn.ClipGradByGlobalNorm(0.2),
], ids=["value", "value_min", "norm", "global_norm"])
def test_clip_in_sgd_steps_matches_jax(make_clip):
    jn, tn = pair(_net)
    jo = J.optimizer.SGD(0.5, parameters=jn.parameters(),
                         grad_clip=make_clip(J))
    to = T.optimizer.SGD(0.5, parameters=tn.parameters(),
                         grad_clip=make_clip(T))
    y = rs.randint(0, 3, (5, 1)).astype("int64")
    for _ in range(3):
        for p, net, opt in ((J, jn, jo), (T, tn, to)):
            loss = p.nn.functional.cross_entropy(net(p.to_tensor(VEC)),
                                                 p.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
    for (n, a), (_, b) in zip(jn.named_parameters(), tn.named_parameters()):
        assert_close(to_numpy(a), to_numpy(b), RTOL, n)


def test_clip_on_raw_gradients_matches_jax():
    import jax.numpy as jnp
    import torch

    grads = [rs.randn(3, 4).astype("f4"), None, 5 * rs.randn(4).astype("f4")]
    for make in (lambda p: p.nn.ClipGradByValue(0.5),
                 lambda p: p.nn.ClipGradByNorm(1.0),
                 lambda p: p.nn.ClipGradByGlobalNorm(2.0)):
        want = make(J)([(i, None if g is None else jnp.asarray(g))
                        for i, g in enumerate(grads)])
        got = make(T)([(i, None if g is None else torch.from_numpy(g))
                       for i, g in enumerate(grads)])
        for (_, a), (_, b) in zip(want, got):
            assert (a is None) == (b is None)
            if a is not None:
                assert_close(np.asarray(a), b.numpy(), RTOL)


def _linear(p):
    p.seed(2)
    return p.nn.Linear(6, 4)


def _conv(p):
    p.seed(3)
    return p.nn.Conv2D(3, 5, 3)


@pytest.mark.parametrize("kind", ["weight_norm", "weight_norm_whole",
                                  "spectral_norm"])
@pytest.mark.parametrize("make,x", [(_linear, VEC), (_conv, IMG)],
                         ids=["linear", "conv"])
def test_reparametrizations_match_jax(kind, make, x):
    def build(p):
        layer = make(p)
        if kind == "spectral_norm":
            return p.nn.utils.spectral_norm(layer, n_power_iterations=2)
        return p.nn.utils.weight_norm(
            layer, dim=None if kind == "weight_norm_whole" else 0)

    jl, tl = pair(build)
    for _ in range(3):
        jo, to = jl(J.to_tensor(x)), tl(T.to_tensor(x))
        assert_close(to_numpy(jo), to_numpy(to), RTOL, "forward")
    w = rs.randn(*to_numpy(jo).shape).astype("f4")
    (jo * J.to_tensor(w)).sum().backward()
    (to * T.to_tensor(w)).sum().backward()
    for (n, a), (_, b) in zip(jl.named_parameters(), tl.named_parameters()):
        assert_close(to_numpy(a.grad), to_numpy(b.grad), RTOL, n)
    for (n, a), (_, b) in zip(jl.state_dict().items(),
                              tl.state_dict().items()):
        assert_close(to_numpy(a), to_numpy(b), RTOL, n)


def test_remove_weight_norm_bakes_the_same_weight():
    jl, tl = pair(lambda p: p.nn.utils.weight_norm(_conv(p)))
    for p, layer in ((J, jl), (T, tl)):
        p.nn.utils.remove_weight_norm(layer)
    assert list(tl.state_dict()) == list(jl.state_dict()) == ["bias", "weight"]
    assert_close(to_numpy(jl.weight), to_numpy(tl.weight), RTOL)
    with pytest.raises(ValueError, match="not weight-normed"):
        T.nn.utils.remove_weight_norm(tl)


def test_parameter_vector_round_trip_matches_jax():
    jn, tn = pair(_net)
    jv = J.nn.utils.parameters_to_vector(jn.parameters())
    tv = T.nn.utils.parameters_to_vector(tn.parameters())
    assert_close(to_numpy(jv), to_numpy(tv), 0.0)
    T.nn.utils.vector_to_parameters(T.to_tensor(2 * to_numpy(tv)),
                                    tn.parameters())
    assert_close(2 * to_numpy(jv),
                 to_numpy(T.nn.utils.parameters_to_vector(tn.parameters())),
                 0.0)
