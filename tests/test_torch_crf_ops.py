"""PyTorch port: the linear-chain CRF (``linear_chain_crf``,
``crf_decoding``) and ``spectral_norm`` of ``ops/tail_ops.py``, each
against the JAX lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every float input gradient compared
(``test_torch_lowerings.check_case``); each op's cases run in one test.
The edge cases: lengths 1, T, values between, 0 (the gold path's last
label wraps to position T - 1, as jnp indexes) and past T (clamped),
labels out of range, the 2-D single-sequence form without ``Length``,
and Viterbi over values on a
coarse grid, so that many steps hold tied candidates: both packages take
the first maximum, and the sums are exact, so the paths are equal.

Tolerance: 1e-5 absolute plus 1e-5 relative (``test_torch_lowerings.TOL``):
float32 log-sum-exps over a few steps in another order; the paths and
masks are equal.
"""
import numpy as np
import pytest

import test_torch_lowerings as tl
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case

CRF_OUTS = ["LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"]
CRF_GRAD = ["LogLikelihood", "EmissionExps", "TransitionExps"]


def _tied(rs, *shape):
    return (rs.randint(-4, 4, shape) / 4.0).astype("f4")


def _labels(rs, d, *shape):
    return rs.randint(0, d, shape).astype("int64")


def _cases():
    rs = np.random.RandomState(232)
    b, t, d = 5, 6, 4
    lens = np.array([1, 6, 3, 0, 8], "int64")
    crf = [
        case("linear_chain_crf", dict(
            Emission=[randn(rs, b, t, d)], Transition=[randn(rs, d + 2, d)],
            Label=[_labels(rs, d, b, t)], Length=[lens]), CRF_OUTS,
            grad=CRF_GRAD),
        case("linear_chain_crf", dict(
            Emission=[randn(rs, 2, t, d)], Transition=[randn(rs, d + 2, d)],
            Label=[_labels(rs, d, 2, t, 1)]), CRF_OUTS, grad=CRF_GRAD),
        case("linear_chain_crf", dict(
            Emission=[randn(rs, 7, d)], Transition=[randn(rs, d + 2, d)],
            Label=[_labels(rs, d, 7, 1)]), CRF_OUTS, grad=CRF_GRAD),
        # labels out of range: read clamped (a negative wraps once); the
        # gradient of a gather through one dropped, of a scalar index
        # (the start and stop weights) clamped, as in jax
        case("linear_chain_crf", dict(
            Emission=[randn(rs, 2, 4, d)], Transition=[randn(rs, d + 2, d)],
            Label=[np.array([[0, -1, d + 1, 2], [-d - 2, 1, d + 3, d]],
                            "int64")],
            Length=[np.array([4, 3], "int64")]), CRF_OUTS, grad=CRF_GRAD),
    ]
    decode = [
        case("crf_decoding", dict(
            Emission=[_tied(rs, b, t, d)], Transition=[_tied(rs, d + 2, d)],
            Length=[lens]), ["ViterbiPath"], grad=[]),
        case("crf_decoding", dict(
            Emission=[_tied(rs, b, t, d)], Transition=[_tied(rs, d + 2, d)],
            Label=[_labels(rs, d, b, t)], Length=[lens]), ["ViterbiPath"],
            grad=[]),
        case("crf_decoding", dict(
            Emission=[randn(rs, 7, d)], Transition=[randn(rs, d + 2, d)]),
            ["ViterbiPath"], grad=[]),
        case("crf_decoding", dict(
            Emission=[_tied(rs, 7, d)], Transition=[_tied(rs, d + 2, d)],
            Label=[_labels(rs, d, 7, 1)]), ["ViterbiPath"], grad=[]),
    ]
    spectral = [
        case("spectral_norm", dict(Weight=[randn(rs, 6, 4, 3, 3)],
                                   U=[randn(rs, 6)], V=[randn(rs, 36)]),
             ["Out"], dict(dim=0, power_iters=2, eps=1e-12)),
        case("spectral_norm", dict(Weight=[randn(rs, 6, 4, 3, 3)],
                                   U=[randn(rs, 4)], V=[randn(rs, 54)]),
             ["Out"], dict(dim=1, power_iters=3, eps=1e-6)),
        case("spectral_norm", dict(Weight=[randn(rs, 5, 7)],
                                   U=[randn(rs, 5)], V=[randn(rs, 7)]),
             ["Out"], dict(dim=0, power_iters=1)),
    ]
    return {"linear_chain_crf": crf, "crf_decoding": decode,
            "spectral_norm": spectral}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_crf_and_spectral_norm_lowering_matches_jax(name):
    for i, c in enumerate(CASES[name]):
        pairs = check_case(f"{name}_{i}", c)
        if name == "crf_decoding":
            assert pairs["out_viterbipath"][0].dtype == np.int32


def test_viterbi_paths_are_shaped_and_masked():
    """A 2-D input gives [T, 1]; past a row's length the path is 0, and
    with ``Label`` the output is a 0 / 1 mask, 0 past the length."""
    paths = [tl._run("torch", *tl._build("torch", c))[0]
             for c in CASES["crf_decoding"]]
    assert paths[2].shape == (7, 1) and paths[3].shape == (7, 1)
    assert paths[0].shape == (5, 6)
    assert (paths[0][0, 1:] == 0).all() and (paths[0][3] == 0).all()
    assert set(np.unique(paths[1])) <= {0, 1}
    assert (paths[1][3] == 0).all()


def test_crf_loss_is_the_negative_log_likelihood():
    """For one sequence of length 2 the loss is logZ - score(gold) with
    logZ the log-sum over every path: checked by enumerating them."""
    rs = np.random.RandomState(7)
    d = 3
    e, tr = randn(rs, 2, d), randn(rs, d + 2, d)
    lbl = np.array([[2], [0]], "int64")
    c = case("linear_chain_crf", dict(Emission=[e], Transition=[tr],
                                      Label=[lbl]), ["LogLikelihood"],
             grad=[])
    got = tl._run("torch", *tl._build("torch", c))[0]
    start, stop, m = tr[0].astype("f8"), tr[1].astype("f8"), tr[2:]

    def score(a, b):
        return start[a] + e[0, a] + m[a, b] + e[1, b] + stop[b]

    logz = np.log(sum(np.exp(score(a, b)) for a in range(d)
                      for b in range(d)))
    np.testing.assert_allclose(got[0, 0], logz - score(2, 0), rtol=1e-5)
