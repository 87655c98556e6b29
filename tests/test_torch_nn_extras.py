"""PyTorch port: the ``conv2d_transpose``, ``group_norm`` and
``instance_norm`` lowerings and their layers (``nn.Conv2DTranspose``,
``GroupNorm``, ``InstanceNorm2D``) against the JAX package's, on the CPU.

Each op case is a one-op program with the generic gradient op after it,
built with each package's IR and run through each package's executor
from the same seeded inputs and output cotangents
(``test_torch_lowerings.py``'s harness); every output and every input
gradient is compared.  The layers: the JAX layer's ``state_dict()``
carried into the port's, the same input through both, outputs and
every gradient.

Tolerance: float32, 1e-5 of the JAX result's largest magnitude (the
rule of ``test_torch_conv_ops.py``): both sides compute in float32 and
differ only in the order of their sums (a transposed convolution's
window, a group's moments) on values of order 1.

The JAX lowering of ``conv2d_transpose`` reads no ``data_format``; the
port's transposes NHWC in and out, so an NHWC case is held to the JAX
package's NCHW result, transposed.  Neither lowering reads
``output_size``: its cases give the size ``output_padding`` gives.
"""
import numpy as np
import pytest

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, check, pair, to_numpy)
from test_torch_conv_ops import _assert_close, _cotangents, _f
from test_torch_lowerings import _build, _case, _run


def _convt(x, w, **attrs):
    a = dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1], groups=1,
             data_format="NCHW", output_padding=[], output_size=[])
    a.update(attrs)
    return _case("conv2d_transpose", dict(Input=[x], Filter=[w]),
                 ["Output"], a, grad=["Output"])


def _groups():
    rs = np.random.RandomState(0)
    x = _f(rs, 2, 4, 5, 6)
    w = _f(rs, 4, 3, 3, 3)        # [in, out / groups, kh, kw]
    return {
        "conv2d_transpose_stride_pad_dilation": [
            _convt(x, w),
            _convt(x, w, strides=[2, 2], paddings=[1, 1]),
            _convt(x, _f(rs, 4, 3, 4, 4), strides=[2, 2], paddings=[1, 1]),
            _convt(x, w, strides=[2, 1], paddings=[0, 2], dilations=[2, 1]),
        ],
        "conv2d_transpose_groups_output_padding": [
            _convt(x, _f(rs, 4, 2, 3, 3), groups=2, strides=[2, 2],
                   paddings=[1, 1]),
            _convt(x, w, strides=[2, 2], paddings=[1, 1],
                   output_padding=[1, 1]),
            _convt(x, w, strides=[3, 2], output_padding=[2, 0],
                   output_size=[17, 13]),
        ],
        # SAME sized from the input; 4-element paddings are (top, bottom,
        # left, right): an asymmetric pair is cropped off a full result
        "conv2d_transpose_same_valid_4pad": [
            _convt(x, w, strides=[2, 2], padding_algorithm="SAME"),
            _convt(x, _f(rs, 4, 3, 4, 4), padding_algorithm="SAME"),
            _convt(x, w, paddings=[2, 2], padding_algorithm="VALID"),
            _convt(x, w, paddings=[0, 2, 1, 0], strides=[2, 2]),
        ],
        "group_norm": [
            _case("group_norm", dict(X=[_f(rs, 2, 6, 4, 5) * 2 + 1],
                                     Scale=[_f(rs, 6)], Bias=[_f(rs, 6)]),
                  ["Y", "Mean", "Variance"], dict(groups=3, epsilon=1e-5),
                  grad=["Y"]),
            _case("group_norm", dict(X=[_f(rs, 3, 8, 7)]),
                  ["Y", "Mean", "Variance"], dict(groups=2, epsilon=1e-3),
                  grad=["Y"]),
        ],
        "instance_norm": [
            _case("instance_norm", dict(X=[_f(rs, 2, 3, 4, 5) * 3 - 1],
                                        Scale=[_f(rs, 3)], Bias=[_f(rs, 3)]),
                  ["Y", "SavedMean", "SavedVariance"], dict(epsilon=1e-5),
                  grad=["Y"]),
        ],
    }


GROUPS = _groups()


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_lowering_matches_jax(group):
    """Every case of the group: outputs and input gradients, shapes and
    types included."""
    for i, case in enumerate(GROUPS[group]):
        cots = _cotangents(case)
        prog, feed, fetch = _build("torch", case, cots)
        got = _run("torch", prog, feed, fetch)
        want = _run("jax", *_build("jax", case, cots))
        assert len(got) == len(want) == len(fetch) > len(case["outs"])
        for n, g, w in zip(fetch, got, want):
            _assert_close(f"{group}[{i}] {n}", g, w)


def test_conv2d_transpose_nhwc():
    """NHWC in the port against the JAX package's NCHW result on the same
    values, transposed (outputs and both gradients)."""
    rs = np.random.RandomState(4)
    x, w = _f(rs, 2, 4, 5, 6), _f(rs, 4, 3, 3, 3)
    for attrs in (dict(strides=[2, 2], paddings=[1, 1]),
                  dict(strides=[2, 2], padding_algorithm="SAME",
                       output_padding=[1, 0])):
        nchw = _convt(x, w, **attrs)
        nhwc = _convt(np.ascontiguousarray(x.transpose(0, 2, 3, 1)), w,
                      data_format="NHWC", **attrs)
        cots = _cotangents(nchw)
        (name, cot), = cots.items()
        want = _run("jax", *_build("jax", nchw, cots))
        got = _run("torch", *_build("torch", nhwc, {
            name: np.ascontiguousarray(cot.transpose(0, 2, 3, 1))}))
        out, dx, dw = got
        _assert_close("Output", out.transpose(0, 3, 1, 2), want[0])
        _assert_close("Input@GRAD", dx.transpose(0, 3, 1, 2), want[1])
        _assert_close("Filter@GRAD", dw, want[2])


IMG = np.random.RandomState(7).randn(2, 4, 6, 6).astype("f4")


@pytest.mark.parametrize("make", [
    lambda p: p.nn.Conv2DTranspose(4, 6, 3, stride=2, padding=1),
    lambda p: p.nn.Conv2DTranspose(4, 6, 4, stride=2, padding=1, groups=2,
                                   bias_attr=False),
    lambda p: p.nn.GroupNorm(2, 4),
    lambda p: p.nn.InstanceNorm2D(4),
], ids=["conv_transpose", "conv_transpose_groups", "group_norm",
        "instance_norm"])
def test_layers_match_jax(make):
    """The layers with the JAX layer's weights: outputs, input gradient
    and every parameter's gradient."""
    jl, tl = pair(make)
    check(jl, tl, IMG)
    for (n, a), (_, b) in zip(jl.named_parameters(), tl.named_parameters()):
        assert_close(to_numpy(a.grad), to_numpy(b.grad), 1e-5, n)


def test_functional_output_size_matches_jax():
    """``F.conv2d_transpose`` with ``output_padding`` and the matching
    ``output_size``, in both packages."""
    rs = np.random.RandomState(9)
    check(lambda x, w: J.nn.functional.conv2d_transpose(
              x, w, stride=2, padding=1, output_padding=1,
              output_size=[12, 12]),
          lambda x, w: T.nn.functional.conv2d_transpose(
              x, w, stride=2, padding=1, output_padding=1,
              output_size=[12, 12]),
          _f(rs, 2, 4, 6, 6), _f(rs, 4, 3, 3, 3))
