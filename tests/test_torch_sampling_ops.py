"""PyTorch port: the sampled losses ``nce`` and ``sample_logits`` of
``ops/sampling_ops.py``, against the JAX lowering, and their draws.

The two packages draw from different generators, so the losses are
compared with both packages' ``_draw_samples`` replaced, inside the test
only (``monkeypatch``), by one fixed draw of classes, each package's
probabilities from its own ``_sampler_prob``: a one-op program and its
gradient op through both executors on the CPU, every output and every
float input gradient compared (``test_torch_lowerings.check_case``), for
the uniform (0), log-uniform (1) and custom (2) samplers, with an
accidental hit in ``sample_logits``.  The ops carry ``seed=3``, as a
gradient of a sampled loss needs: the generic gradient replays the
forward, which can draw again only from a seeded generator.  Without a
seed, both packages refuse the gradient.

The port's own draws are held to their statistics on the CPU generator:
1,000,000 draws of each sampler, the counts of each class (bins merged
until each expects at least 100) within 5 standard deviations of the
sampler's probability, and no draw of a class of probability 0.

Tolerance: 1e-5 absolute plus 1e-5 relative (``test_torch_lowerings.TOL``):
float32 on both sides, the logits' dot products in another order; the
sample ids equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lowerings as tl
from paddle_tpu.ops import sampling_ops as jsamp
from paddle_tpu_torch.ops import sampling_ops as tsamp
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case

FIXED = np.array([3, 0, 7, 3, 11, 5, 2, 9], "int32")


def _custom(ctx, op, xp):
    p = ctx.in1(op, "CustomDistProbs")
    if p is None:
        return None
    p = p.reshape(-1)
    p = p.astype(jnp.float32) if xp is jnp else p.float()
    return p / p.sum()


def _fixed_jax(ctx, op, n_samples, n_classes):
    sampler = int(op.attr("sampler", 0))
    custom = _custom(ctx, op, jnp) if sampler == 2 else None
    s = jnp.asarray(FIXED[:n_samples])
    return s, jsamp._sampler_prob(s, sampler, n_classes, custom), custom


def _fixed_torch(ctx, op, n_samples, n_classes):
    sampler = int(op.attr("sampler", 0))
    custom = _custom(ctx, op, torch) if sampler == 2 else None
    s = torch.from_numpy(FIXED[:n_samples]).to(ctx.device)
    return s, tsamp._sampler_prob(s, sampler, n_classes, custom), custom


@pytest.fixture
def fixed_draw(monkeypatch):
    monkeypatch.setattr(jsamp, "_draw_samples", _fixed_jax)
    monkeypatch.setattr(tsamp, "_draw_samples", _fixed_torch)


def _probs(rs, c):
    p = rs.rand(c).astype("f4") * 3
    p[[1, 4]] = 0.0
    return p


def _nce_case(sampler, seed=3, bias=True, grad=("Cost", "SampleLogits")):
    rs = np.random.RandomState(sampler)
    c, d = 12, 6
    ins = dict(Input=[randn(rs, 5, d)], Label=[rs.randint(
        0, c, (5, 2)).astype("int64")], Weight=[randn(rs, c, d)])
    if bias:
        ins["Bias"] = [randn(rs, c)]
    if sampler == 2:
        ins["CustomDistProbs"] = [_probs(rs, c)]
    return case("nce", ins, ["Cost", "SampleLogits", "SampleLabels"],
                dict(num_total_classes=c, num_neg_samples=5, sampler=sampler,
                     seed=seed), grad=list(grad))


def _sample_logits_case(sampler, hits=True):
    rs = np.random.RandomState(10 + sampler)
    c = 12
    label = rs.randint(0, c, (4, 2)).astype("int64")
    label[0, 0] = FIXED[0]          # an accidental hit in row 0
    ins = dict(Logits=[randn(rs, 4, c)], Labels=[label])
    if sampler == 2:
        ins["CustomDistProbs"] = [_probs(rs, c)]
    return case("sample_logits", ins,
                ["SampledLogits", "SampledLabels", "Samples",
                 "Probabilities", "LogitsDim", "LabelsDim"],
                dict(num_samples=6, sampler=sampler, seed=3,
                     remove_accidental_hits=hits),
                grad=["SampledLogits", "Probabilities"])


@pytest.mark.parametrize("sampler", [0, 1, 2])
def test_nce_matches_jax_on_a_fixed_draw(fixed_draw, sampler):
    pairs = check_case(f"nce_{sampler}", _nce_case(sampler))
    got, want = pairs["out_samplelabels"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[:, 2:], np.broadcast_to(FIXED[:5],
                                                              (5, 5)))
    check_case(f"nce_{sampler}_nobias", _nce_case(sampler, bias=False,
                                                  grad=["Cost"]))


@pytest.mark.parametrize("sampler", [0, 1, 2])
def test_sample_logits_matches_jax_on_a_fixed_draw(fixed_draw, sampler):
    for hits in (True, False):
        pairs = check_case(f"sample_logits_{sampler}_{hits}",
                           _sample_logits_case(sampler, hits))
        logits = pairs["out_sampledlogits"][0]
        assert (logits[0, 2] < -1e19) == hits
        for n in ("out_samples", "out_logitsdim", "out_labelsdim"):
            assert pairs[n][0].dtype == np.int32


def test_unseeded_nce_gradient_is_refused_by_both():
    """The generic gradient has no generator to replay an unseeded
    draw, in either package."""
    c = _nce_case(0, seed=0)
    cots = {"out_cost": np.ones((5, 1), "f4")}
    for which in ("jax", "torch"):
        with pytest.raises(Exception, match="random ops"):
            tl._run(which, *tl._build(which, c, cots))


def test_seeded_nce_replays_its_draw():
    """With a seed the port's forward draws the same classes at each run
    and its gradient replays them: the gradient equals autograd's through
    one forward of the same draw."""
    c = _nce_case(1, grad=["Cost"])
    prog, feed, fetch = tl._build("torch", c)
    runs = [tl._run("torch", prog, feed, fetch) for _ in range(2)]
    np.testing.assert_array_equal(runs[0][2], runs[1][2])
    cot = np.ones((5, 1), "f4")
    prog, feed, fetch = tl._build("torch", c, {"out_cost": cot})
    out = dict(zip(fetch, tl._run("torch", prog, feed, fetch)))
    samples = torch.from_numpy(runs[0][2][0, 2:].astype("int64"))
    x = torch.from_numpy(c["inputs"]["Input"][0]).requires_grad_()
    w = torch.from_numpy(c["inputs"]["Weight"][0])
    b = torch.from_numpy(c["inputs"]["Bias"][0])
    label = torch.from_numpy(c["inputs"]["Label"][0])
    k, n = 5.0, 12

    def q(i):
        return torch.log((i.float() + 2) / (i.float() + 1)) / np.log(n + 1.0)

    true = (x[:, None] * w[label]).sum(-1) + b[label] - torch.log(k * q(label))
    noise = x @ w[samples].t() + b[samples] - torch.log(k * q(samples))
    cost = (torch.nn.functional.softplus(-true).sum(1)
            + torch.nn.functional.softplus(noise).sum(1))
    (dx,) = torch.autograd.grad(cost.sum(), x)
    np.testing.assert_allclose(out["input_0@GRAD"], dx.numpy(), **tl.TOL)


class _Ctx:
    def __init__(self, probs=None):
        self.device = torch.device("cpu")
        self.probs = probs
        self.gen = torch.Generator().manual_seed(123)

    def in1(self, op, slot):
        return self.probs if slot == "CustomDistProbs" else None

    def next_generator(self):
        return self.gen


class _Op:
    type = "nce"

    def __init__(self, sampler):
        self.attrs = dict(sampler=sampler)

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def draws_within_bounds(samples, probs, n_sigma=5.0, min_expected=100.0):
    """Counts of each class, bins merged in class order until each
    expects ``min_expected``, within ``n_sigma`` binomial standard
    deviations; no draw of a class of probability 0.  Returns the worst
    z and the number of merged bins."""
    n = len(samples)
    counts = np.bincount(samples, minlength=len(probs)).astype("f8")
    assert counts.sum() == n and (counts[probs == 0] == 0).all()
    worst, bins, acc_c, acc_p = 0.0, 0, 0.0, 0.0
    for cnt, p in zip(counts, probs.astype("f8")):
        acc_c, acc_p = acc_c + cnt, acc_p + p
        if n * acc_p >= min_expected:
            z = abs(acc_c - n * acc_p) / np.sqrt(n * acc_p * (1 - acc_p))
            worst, bins, acc_c, acc_p = max(worst, z), bins + 1, 0.0, 0.0
    assert worst <= n_sigma, (worst, bins)
    return worst, bins


@pytest.mark.parametrize("sampler,n_classes", [(0, 50), (1, 1000), (2, 30)])
def test_draws_follow_the_sampler_probabilities(sampler, n_classes):
    probs = None
    if sampler == 2:
        raw = np.random.RandomState(4).rand(n_classes).astype("f4")
        raw[[0, 7, 29]] = 0.0
        probs = torch.from_numpy(raw)
    s, p_s, custom = tsamp._draw_samples(_Ctx(probs), _Op(sampler),
                                         1_000_000, n_classes)
    assert s.dtype == torch.int32
    every = torch.arange(n_classes)
    p_all = tsamp._sampler_prob(every, sampler, n_classes, custom).numpy()
    np.testing.assert_allclose(p_all.sum(), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(
        p_s.numpy(), p_all[s.long().numpy()])
    worst, bins = draws_within_bounds(s.long().numpy(), p_all)
    assert bins >= min(n_classes, 20)
