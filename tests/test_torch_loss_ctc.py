"""PyTorch port: ``warpctc`` against the JAX lowering (``optax.ctc_loss``).

A one-op program and its gradient op through both packages' executors
on the CPU, ``Loss``, ``WarpCTCGrad`` (zeros in both) and the gradient
of the logits compared (``test_torch_lowerings.check_case``), on padded
[T, B, C] logits with length tensors.  Tolerance: 1e-5 absolute plus 1e-5
relative; both run the same float32 forward recursion over T steps
(values of order 10, so the relative term leads).  The infeasible row
(a label longer than its logits allow) is ~1e5 in both: optax scores a
forbidden transition with log(eps) = -1e5, which the port's
``ctc_loss`` copies, where ``F.ctc_loss`` gives inf.  That row's
gradient is held to ``INFEASIBLE_TOL`` (the reason is beside it).

Edge cases: repeated labels (a blank must separate them), a row whose
labels cannot fit its logits, a blank that is the last class, and
``norm_by_times``.  The feasible rows also equal ``F.ctc_loss``, the
exact CTC loss, within float32 rounding.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu_torch as tpkg
from paddle_tpu_torch.framework import program as tprogram
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case

T, B, C, N = 12, 4, 6, 5
# The infeasible row's loss is 1.00005e5, where float32's step is 2**-7.
# Each package's gradient there takes exp of a difference of such values
# (jax's logaddexp rule exp(x - out), torch's 1 / (1 + exp(y - x))), so
# each is ~1e-3 from the float64 gradient (measured on the CPU: 1.1e-3
# the port, 1.6e-3 the JAX package).  That case is held to half the
# step; its feasible rows and every loss keep 1e-5 (the test below).
INFEASIBLE_TOL = dict(atol=4e-3, rtol=1e-5)


def _inputs(rs, blank=0, infeasible=False):
    lo = 1 if blank == 0 else 0
    labels = rs.randint(lo, lo + C - 1, (B, N)).astype("int32")
    labels[1, :4] = [2, 2, 3, 3]                  # repeats
    label_len = np.array([3, 4, 5, 2], "int64")
    logits_len = np.array([12, 9, 11, 6], "int64")
    if infeasible:
        # 4 labels with two repeats need 6 steps; 5 are given
        labels[3, :4] = [1, 1, 4, 4]
        label_len[3], logits_len[3] = 4, 5
    return dict(Logits=[randn(rs, T, B, C)], Label=[labels],
                LogitsLength=[logits_len], LabelLength=[label_len])


def _cases():
    rs = np.random.RandomState(0)
    return {
        "warpctc": case("warpctc", _inputs(rs), ["Loss", "WarpCTCGrad"],
                        dict(blank=0, norm_by_times=False), grad=["Loss"]),
        "warpctc_norm_by_times": case(
            "warpctc", _inputs(rs), ["Loss", "WarpCTCGrad"],
            dict(blank=0, norm_by_times=True), grad=["Loss"]),
        "warpctc_last_blank": case(
            "warpctc", _inputs(rs, blank=C - 1), ["Loss", "WarpCTCGrad"],
            dict(blank=C - 1, norm_by_times=False), grad=["Loss"]),
        "warpctc_infeasible": case(
            "warpctc", _inputs(rs, infeasible=True), ["Loss", "WarpCTCGrad"],
            dict(blank=0, norm_by_times=False), grad=["Loss"],
            tol=INFEASIBLE_TOL),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_warpctc_matches_jax(name):
    c = CASES[name]
    pairs = check_case(name, c)
    loss = pairs["out_loss"][0][:, 0]
    assert (pairs["out_warpctcgrad"][0] == 0).all()
    assert np.isfinite(pairs["logits_0@GRAD"][0]).all()
    ins = {k: torch.from_numpy(v[0]) for k, v in c["inputs"].items()}
    exact = F.ctc_loss(torch.log_softmax(ins["Logits"], -1),
                       ins["Label"].long(), ins["LogitsLength"],
                       ins["LabelLength"], blank=c["attrs"]["blank"],
                       reduction="none").numpy()
    if c["attrs"]["norm_by_times"]:
        exact = exact / ins["LogitsLength"].numpy()
    feasible = np.isfinite(exact)
    assert feasible.sum() == (3 if name == "warpctc_infeasible" else B)
    np.testing.assert_allclose(loss[feasible], exact[feasible], rtol=1e-5)
    assert (loss[~feasible] > 1e4).all() and np.isfinite(loss).all()
    np.testing.assert_allclose(loss, pairs["out_loss"][1][:, 0],
                               rtol=1e-5)
    g, w = pairs["logits_0@GRAD"]
    np.testing.assert_allclose(g[:, feasible], w[:, feasible], atol=1e-5,
                               rtol=1e-5)


def test_warpctc_without_lengths_raises():
    """LoD inputs (no LogitsLength / LabelLength) are refused, as in the
    JAX package."""
    prog = tprogram.Program()
    blk = prog.global_block
    blk.create_var(name="logits", shape=(T, B, C), dtype="float32")
    blk.create_var(name="label", shape=(B, N), dtype="int32")
    blk.create_var(name="loss")
    blk.append_op("warpctc", {"Logits": ["logits"], "Label": ["label"]},
                  {"Loss": ["loss"]}, {"blank": 0})
    with pytest.raises(NotImplementedError, match="LogitsLength"):
        tpkg.Executor(tpkg.CPUPlace()).run(
            prog, feed={"logits": np.zeros((T, B, C), "f4"),
                        "label": np.ones((B, N), "int32")},
            fetch_list=["loss"], scope=tpkg.framework.Scope())
