"""PyTorch port: the op lowerings of the static ResNet program.

Each case is a one-op program and the gradient op ``append_backward``
would give it, built with each package's IR and run through each
package's executor on the CPU (``test_torch_lowerings.py``'s harness),
from the same seeded numpy inputs and output cotangents; every output and
every input gradient is compared.  The JAX package differentiates
``conv2d``, ``pool2d``, ``batch_norm`` and ``relu`` with ``jax.vjp`` of
its lowerings; the port runs its explicit ``conv2d_grad`` and
``batch_norm_grad``, and the generic gradient (its forward replayed under
autograd) for ``pool2d`` and ``relu``.  The explicit gradients are held to
the port's own generic gradient too.

Tolerances, relative to the largest magnitude of the JAX result:
- float32, 1e-5: both sides compute in float32 and differ only in the
  order of their sums (a convolution's window, a batch norm's moments) on
  values of order 1;
- bfloat16, 2**-7: both accumulate in float32 and round the result to
  bfloat16 (8 significant bits), at an order of summation that can move a
  result across a rounding boundary: one step of the largest value.

``uniform_random`` draws from a different generator than the JAX
package's, so it is held to its statistics instead.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpkg
from paddle_tpu_torch.framework import lowering as tlowering
from paddle_tpu_torch.framework import program as tprogram

from test_torch_lowerings import _build, _case, _run

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7


def _f(rs, *shape):
    return rs.randn(*shape).astype("f4")


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def _conv(x, w, grad=("Output",), **attrs):
    a = dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1], groups=1,
             data_format="NCHW")
    a.update(attrs)
    return _case(a.pop("type", "conv2d"), dict(Input=[x], Filter=[w]),
                 ["Output"], a, grad=grad)


def _pool(x, **attrs):
    a = dict(pooling_type="max", ksize=[2, 2], strides=[2, 2],
             paddings=[0, 0], global_pooling=False, exclusive=True,
             ceil_mode=False, adaptive=False, data_format="NCHW")
    a.update(attrs)
    return _case("pool2d", dict(X=[x]), ["Out"], a)


BN_OUTS = ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]


def _bn(rs, x, c, **attrs):
    a = dict(momentum=0.9, epsilon=1e-5, is_test=False,
             use_global_stats=False, data_layout="NCHW")
    a.update(attrs)
    ins = dict(X=[x], Scale=[_f(rs, c)], Bias=[_f(rs, c)],
               Mean=[_f(rs, c) * 0.1],
               Variance=[np.abs(_f(rs, c)) + 0.5])
    return _case("batch_norm", ins, BN_OUTS, a, grad=["Y"])


def _groups():
    rs = np.random.RandomState(0)
    x = _f(rs, 2, 4, 9, 10)
    w = _f(rs, 6, 4, 3, 3)
    x_nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return {
        "conv2d_strides_dilations": [
            _conv(x, w),
            _conv(x, w, strides=[2, 1], paddings=[1, 2]),
            _conv(x, w, strides=[2, 2], paddings=[2, 2], dilations=[2, 1]),
            _conv(x, _f(rs, 6, 4, 1, 1), strides=[2, 2]),
            _conv(_f(rs, 2, 3, 16, 16), _f(rs, 8, 3, 7, 7), strides=[2, 2],
                  paddings=[3, 3]),
        ],
        "conv2d_groups_depthwise": [
            _conv(x, _f(rs, 6, 2, 3, 3), groups=2, paddings=[1, 1]),
            _conv(x, _f(rs, 4, 1, 3, 3), type="depthwise_conv2d",
                  groups=4, paddings=[1, 1]),
            _conv(x, _f(rs, 8, 1, 3, 3), type="depthwise_conv2d",
                  groups=4, strides=[2, 2]),
        ],
        # SAME on an even size pads (0, 1); 4-element paddings are
        # (top, bottom, left, right)
        "conv2d_same_valid_4pad": [
            _conv(x, w, strides=[2, 2], padding_algorithm="SAME"),
            _conv(x, _f(rs, 6, 4, 4, 4), padding_algorithm="SAME"),
            _conv(x, w, paddings=[5, 5], padding_algorithm="VALID"),
            _conv(x, w, paddings=[0, 2, 1, 0], strides=[2, 2]),
        ],
        "conv2d_nhwc": [
            _conv(x_nhwc, w, paddings=[1, 1], data_format="NHWC"),
            _conv(x_nhwc, w, strides=[2, 2], data_format="NHWC",
                  padding_algorithm="SAME"),
        ],
        "conv2d_bfloat16": [
            _conv(_bf16(x), _bf16(w), paddings=[1, 1]),
            _conv(_bf16(x), _bf16(w), strides=[2, 2],
                  padding_algorithm="SAME"),
        ],
        "pool2d_max_avg_exclusive": [
            _pool(x),
            _pool(x, ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
            _pool(x, pooling_type="avg", ksize=[3, 3], strides=[1, 2],
                  paddings=[1, 1]),
            _pool(x, pooling_type="avg", ksize=[3, 3], strides=[2, 2],
                  paddings=[1, 1], exclusive=False),
        ],
        # pads above k / 2 and unequal pairs: F.pad first
        "pool2d_asymmetric_pads": [
            _pool(x, ksize=[2, 2], strides=[2, 2], paddings=[1, 1]),
            _pool(x, ksize=[3, 3], strides=[2, 2], paddings=[0, 1, 2, 0]),
            _pool(x, pooling_type="avg", ksize=[3, 3], strides=[2, 2],
                  paddings=[0, 1, 2, 0]),
            _pool(x, pooling_type="avg", ksize=[2, 3], strides=[2, 2],
                  paddings=[0, 1, 2, 0], exclusive=False),
            _pool(x, ksize=[2, 2], strides=[2, 2],
                  padding_algorithm="SAME"),
        ],
        "pool2d_global_adaptive": [
            _pool(x, global_pooling=True, pooling_type="avg"),
            _pool(x, global_pooling=True),
            _pool(x, adaptive=True, ksize=[3, 5], pooling_type="avg"),
            _pool(x, adaptive=True, ksize=[3, 5]),
            _pool(x, adaptive=True, ksize=[4, 3], pooling_type="avg"),
            _pool(x, adaptive=True, ksize=[4, 3]),
            _pool(x, adaptive=True, ksize=[1, 1]),
        ],
        "pool2d_nhwc_bfloat16_int": [
            _pool(x_nhwc, ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                  data_format="NHWC"),
            _pool(x_nhwc, pooling_type="avg", data_format="NHWC",
                  global_pooling=True),
            _pool(_bf16(x), ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
            _pool(_bf16(x), global_pooling=True, pooling_type="avg"),
            dict(_pool((x * 50).astype("int32"), ksize=[3, 3],
                       strides=[2, 2], paddings=[2, 0, 1, 1]), grad=[]),
        ],
        "batch_norm_training": [
            _bn(rs, x * 2 + 1, 4),
            _bn(rs, _f(rs, 8, 3), 3),
            _bn(rs, np.ascontiguousarray(x_nhwc * 3 - 2), 4,
                data_layout="NHWC"),
        ],
        "batch_norm_global_stats": [
            _bn(rs, x * 2 + 1, 4, is_test=True),
            _bn(rs, x, 4, use_global_stats=True),
            _bn(rs, x_nhwc, 4, is_test=True, data_layout="NHWC"),
        ],
        "batch_norm_bfloat16": [
            _bn(rs, _bf16(x * 2 + 1), 4),
            _bn(rs, _bf16(x), 4, is_test=True),
        ],
        "relu_scale": [
            _case("relu", dict(X=[_f(rs, 3, 7)]), ["Out"]),
            _case("relu", dict(X=[_bf16(_f(rs, 3, 7))]), ["Out"]),
            _case("scale", dict(X=[_f(rs, 3, 4)]), ["Out"],
                  dict(scale=0.5, bias=-1.0, bias_after_scale=True)),
            _case("scale", dict(X=[_f(rs, 3, 4)]), ["Out"],
                  dict(scale=2.0, bias=0.25, bias_after_scale=False)),
            _case("scale", dict(X=[_f(rs, 3, 4)],
                                ScaleTensor=[np.array([1.5], "f4")]),
                  ["Out"], dict(scale=9.0, bias=0.5,
                                bias_after_scale=True)),
            _case("scale", dict(X=[_bf16(_f(rs, 3, 4))]), ["Out"],
                  dict(scale=1.0 / 127.5, bias=-1.0,
                       bias_after_scale=True)),
        ],
        "momentum_sgd": [
            _momentum(rs),
            _momentum(rs, use_nesterov=True),
            _momentum(rs, regularization_method="l2_decay",
                      regularization_coeff=0.1),
            _momentum(rs, use_nesterov=True,
                      regularization_method="l2_decay",
                      regularization_coeff=1e-4),
            _case("sgd", dict(Param=[_f(rs, 4, 3)], Grad=[_f(rs, 4, 3)],
                              LearningRate=[np.array([0.1], "f4")]),
                  ["ParamOut"], grad=[]),
        ],
    }


def _momentum(rs, **attrs):
    a = dict(mu=0.9, use_nesterov=False, regularization_method="",
             regularization_coeff=0.0)
    a.update(attrs)
    return _case("momentum", dict(Param=[_f(rs, 4, 3)], Grad=[_f(rs, 4, 3)],
                                  Velocity=[_f(rs, 4, 3)],
                                  LearningRate=[np.array([0.1], "f4")]),
                 ["ParamOut", "VelocityOut"], a, grad=[])


GROUPS = _groups()


def _f32(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.astype("f4")
    return a.astype("f4") if a.dtype.kind in "fiub" else a


def _cotangents(case):
    prog, feed, fetch = _build("torch", case)
    probe = dict(zip(fetch, _run("torch", prog, feed, fetch)))
    rs = np.random.RandomState(1)
    cots = {}
    for slot in case["grad"]:
        out = probe[f"out_{slot.lower()}"]
        cots[f"out_{slot.lower()}"] = rs.randn(*out.shape).astype(out.dtype)
    return cots


def _assert_close(name, got, want):
    """``got`` within the stated share of ``want``'s largest magnitude
    (bfloat16 rule where either side is bfloat16)."""
    rtol = BF16_RTOL if ml_dtypes.bfloat16 in (np.asarray(got).dtype,
                                               np.asarray(want).dtype) \
        else F32_RTOL
    assert np.asarray(got).dtype == np.asarray(want).dtype, name
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    scale = max(float(np.abs(w).max()) if w.size else 0.0, 1e-30)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= rtol * scale, f"{name}: {err} > {rtol} * {scale}"


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_lowering_matches_jax(group):
    """Every case of the group: outputs and input gradients of the port
    against the JAX package's, shapes and types included."""
    for i, case in enumerate(GROUPS[group]):
        cots = _cotangents(case)
        prog, feed, fetch = _build("torch", case, cots)
        got = _run("torch", prog, feed, fetch)
        want = _run("jax", *_build("jax", case, cots))
        assert len(got) == len(want) == len(fetch)
        assert len(fetch) > len(case["outs"]) or not case["grad"]
        for n, g, w in zip(fetch, got, want):
            _assert_close(f"{group}[{i}] {n}", g, w)


@pytest.mark.parametrize("fwd", ["conv2d", "depthwise_conv2d",
                                 "batch_norm"])
def test_explicit_gradient_matches_the_generic_one(fwd, monkeypatch):
    """The port's explicit gradient against its own generic gradient (the
    forward replayed under autograd, ``ops/grad_generic.py``) on the
    same cases; both run only in the port."""
    cases = [c for g in ("conv2d_strides_dilations", "conv2d_groups_depthwise",
                         "conv2d_same_valid_4pad", "conv2d_nhwc",
                         "batch_norm_training", "batch_norm_global_stats")
             for c in GROUPS[g] if c["type"] == fwd]
    assert cases
    for i, case in enumerate(cases):
        cots = _cotangents(case)
        prog, feed, fetch = _build("torch", case, cots)
        explicit = _run("torch", prog, feed, fetch)
        with monkeypatch.context() as m:
            m.delitem(tlowering.LOWERINGS, fwd + "_grad")
            assert tlowering.get_lowering(fwd + "_grad") is \
                tlowering.GENERIC_GRAD_LOWERING
            generic = _run("torch", prog, feed, fetch)
        for n, g, w in zip(fetch, explicit, generic):
            _assert_close(f"{fwd}[{i}] {n}", g, w)


def test_pool2d_ignores_ceil_mode():
    """Like the JAX lowering, ``pool2d`` sizes its output by floor
    whatever ``ceil_mode`` says (the reference's op would give 5 x 5
    here, not 4 x 4): a difference by design, pinned."""
    x = _f(np.random.RandomState(2), 1, 2, 9, 9)
    for ptype in ("max", "avg"):
        case = _pool(x, pooling_type=ptype, ksize=[2, 2], strides=[2, 2],
                     ceil_mode=True)
        got = _run("torch", *_build("torch", case))[0]
        want = _run("jax", *_build("jax", case))[0]
        assert got.shape == want.shape == (1, 2, 4, 4)
        _assert_close(ptype, got, want)
        floor = _run("torch", *_build("torch", dict(
            case, attrs=dict(case["attrs"], ceil_mode=False))))[0]
        np.testing.assert_array_equal(got, floor)


def test_uniform_random_statistics():
    """The fc weight's initializer: in [min, max), mean and variance
    within 5 standard errors of the uniform law's, in the requested
    type; a nonzero ``seed`` attr fixes the draw."""
    lo, hi, shape = -0.3, 0.5, (300, 400)

    def draw(seed, dtype=1):
        prog = tprogram.Program()
        prog.random_seed = 5
        blk = prog.global_block
        blk.create_var(name="w", shape=shape, dtype="float32",
                       persistable=True)
        blk.append_op("uniform_random", {}, {"Out": ["w"]},
                      dict(shape=list(shape), min=lo, max=hi, dtype=dtype,
                           seed=seed))
        scope = tpkg.framework.Scope()
        tpkg.Executor(tpkg.CPUPlace()).run(prog, scope=scope)
        return scope.get_var("w")

    w = draw(0)
    assert w.dtype == torch.float32 and tuple(w.shape) == shape
    assert float(w.min()) >= lo and float(w.max()) < hi
    n = w.numel()
    var = (hi - lo) ** 2 / 12
    assert abs(float(w.mean()) - (lo + hi) / 2) < 5 * np.sqrt(var / n)
    # the variance of a uniform sample's variance: (mu4 - var^2) / n
    mu4 = (hi - lo) ** 4 / 80
    assert abs(float(w.var()) - var) < 5 * np.sqrt((mu4 - var ** 2) / n)
    assert torch.equal(draw(17), draw(17))
    assert not torch.equal(draw(17), draw(18))
    assert draw(0, dtype=4).dtype == torch.bfloat16
