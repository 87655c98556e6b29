"""PyTorch port: ``paddle_tpu_torch.distribution`` against the JAX
package's ``distribution``.

``log_prob``, ``probs``, ``entropy`` and ``kl_divergence`` of the same
parameters and values agree within 1e-6 (float32 closed forms of values
of order 1 on both sides).  The two packages draw from different
generators (threefry keys there, a ``torch.Generator`` here), so the
port's samples are held to their statistics: 2e5 draws a distribution,
each moment within 5 standard errors, each category's share within 5
binomial standard deviations; a seeded draw repeats itself.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_dygraph_parity import _jax_eager_keys_kept  # noqa: F401

TOL = dict(atol=1e-6, rtol=1e-6)
DRAWS = 200_000


def _np(t):
    return np.asarray(t.numpy())


def _both(make):
    return make(J.distribution), make(T.distribution)


def _close(a, b):
    np.testing.assert_allclose(_np(b), _np(a), **TOL)


LOC = np.array([0.3, -1.2, 2.0], "f4")
SCALE = np.array([0.5, 1.5, 2.5], "f4")


def test_normal_matches_jax():
    jn, tn = _both(lambda d: d.Normal(LOC, SCALE))
    jo, to = _both(lambda d: d.Normal(LOC[::-1].copy(), SCALE[::-1].copy()))
    v = np.array([0.1, -2.0, 3.5], "f4")
    _close(jn.log_prob(v), tn.log_prob(v))
    _close(jn.probs(v), tn.probs(v))
    _close(jn.entropy(), tn.entropy())
    _close(jn.kl_divergence(jo), tn.kl_divergence(to))
    with pytest.raises(NotImplementedError):
        tn.kl_divergence(T.distribution.Uniform(0.0, 1.0))


def test_uniform_matches_jax():
    low, high = np.array([0.0, -1.0], "f4"), np.array([2.0, 3.0], "f4")
    ju, tu = _both(lambda d: d.Uniform(low, high))
    v = np.array([[0.5, -1.5], [2.0, 2.9]], "f4")   # outside: -inf, 0
    _close(ju.log_prob(v), tu.log_prob(v))
    _close(ju.probs(v), tu.probs(v))
    _close(ju.entropy(), tu.entropy())
    assert np.isneginf(_np(tu.log_prob(v))[[0, 1], [1, 0]]).all()


@pytest.mark.parametrize("logits", [
    np.array([0.2, -1.0, 1.5, 0.0], "f4"),
    np.array([[0.2, -1.0, 1.5], [2.0, 0.1, -0.3]], "f4")])
def test_categorical_matches_jax(logits):
    jc, tc = _both(lambda d: d.Categorical(logits))
    jo, to = _both(lambda d: d.Categorical(logits[..., ::-1].copy()))
    value = np.array([2, 0], "int64") if logits.ndim == 2 \
        else np.array([3, 1, 2], "int64")
    _close(jc.log_prob(value), tc.log_prob(value))
    _close(jc.probs(value), tc.probs(value))
    _close(jc.entropy(), tc.entropy())
    _close(jc.kl_divergence(jo), tc.kl_divergence(to))


def _within(mean, want, sd, n):
    assert abs(mean - want) <= 5 * sd / np.sqrt(n), (mean, want)


def test_normal_and_uniform_samples_by_their_statistics():
    T.seed(11)
    x = _np(T.distribution.Normal(LOC, SCALE).sample([DRAWS]))
    assert x.shape == (DRAWS, 3)
    for j in range(3):
        _within(x[:, j].mean(), LOC[j], SCALE[j], DRAWS)
        # the variance's standard error: sd^2 * sqrt(2 / n)
        assert abs(x[:, j].var() - SCALE[j] ** 2) <= \
            5 * SCALE[j] ** 2 * np.sqrt(2 / DRAWS)
    u = _np(T.distribution.Uniform(-1.0, 3.0).sample([DRAWS]))
    assert u.min() >= -1.0 and u.max() < 3.0
    _within(u.mean(), 1.0, 4 / np.sqrt(12), DRAWS)


def test_categorical_samples_by_their_statistics():
    logits = np.array([0.2, -1.0, 1.5, 0.0], "f4")
    s = _np(T.distribution.Categorical(logits).sample([DRAWS], seed=3))
    assert s.shape == (DRAWS,) and s.dtype == np.int64
    p = np.exp(logits) / np.exp(logits).sum()
    share = np.bincount(s, minlength=4) / DRAWS
    assert (np.abs(share - p) <= 5 * np.sqrt(p * (1 - p) / DRAWS)).all()
    two = _np(T.distribution.Categorical(
        np.zeros((2, 3), "f4")).sample([5], seed=3))
    assert two.shape == (5, 2)


def test_a_seeded_draw_repeats_on_the_tensors_generator():
    n = T.distribution.Normal(LOC, SCALE)
    a, b = _np(n.sample([4], seed=5)), _np(n.sample([4], seed=5))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _np(n.sample([4], seed=6)))
    assert n.sample([2])._value.device == torch.device("cpu")
    T.seed(7)
    c = _np(n.sample([4]))
    T.seed(7)
    np.testing.assert_array_equal(c, _np(n.sample([4])))
