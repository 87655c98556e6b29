"""PyTorch port: flash attention with a streamed additive bias (B1).

The port's plain version -- what ``flash_attention_bias`` runs on CPU
tensors -- and its autograd backward (the port of ``_chunked_bwd``) are
held against the JAX package's ``flash_attention_bias`` run through the
Pallas kernel in interpret mode, and its ``jax.vjp``, on the same numpy
inputs: bias none / key mask / full, broadcast bias shapes, causal, head
dims 64 and 128, float32 and bfloat16.  The CUDA kernel runs only on the
card, where ``chip_smoke.py`` holds it against the same plain version;
here the wrapper's argument checks are exercised with ``meta`` tensors,
which need no GPU.

Tolerances:
- float32 forward: 2e-5 absolute plus 1e-4 relative, the JAX package's
  own for its kernel against its plain composition (float32 on both
  sides; the kernel sums key blocks online, the plain version at once);
- float32 gradients: 1e-4 absolute plus 1e-4 relative: both sides run
  the same q-chunked recompute in float32, and dq/dk/dv/dbias are sums
  over up to 256 positions of products of O(1) terms;
- bfloat16 forward: one bfloat16 step, 2**-7 relative (8 significant
  bits), plus 1e-6 absolute: both sides sum in float32 from the same
  bfloat16 inputs and round once, so float32 summation order can move a
  result across one rounding boundary.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from paddle_tpu.ops.pallas_attention import flash_attention_bias as jflash
from paddle_tpu_torch.ops import flash_attention_bias as fab

SCALE = 0.125
FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-6, rtol=2.0 ** -7)


def _inputs(seed, B=2, H=2, S=256, D=64, bias="key", bias_shape=None):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, S, D).astype("f4") for _ in range(3))
    if bias == "none":
        b = None
    elif bias == "key":
        keep = rs.rand(B, 1, 1, S) > 0.2
        b = np.where(keep, 0.0, -1e9).astype("f4")
    else:
        b = rs.randn(*(bias_shape or (B, H, S, S))).astype("f4")
    return q, k, v, b


def _jax_fwd(q, k, v, b, causal):
    conv = [None if a is None else jnp.asarray(a) for a in (q, k, v, b)]
    return np.asarray(jflash(*conv, sm_scale=SCALE, causal=causal,
                             interpret=True))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", ["none", "key", "full"])
def test_plain_forward_matches_jax_kernel(bias, causal, D):
    q, k, v, b = _inputs(0, S=256 if D == 64 else 128, D=D, bias=bias)
    want = _jax_fwd(q, k, v, b, causal)
    got = fab.flash_attention_bias(*map(_t, (q, k, v, b)), sm_scale=SCALE,
                                   causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("bias", ["none", "key", "full"])
def test_bfloat16_forward_matches_jax_kernel(bias):
    q, k, v, b = _inputs(1, bias=bias)
    q, k, v, b = (None if a is None else a.astype(ml_dtypes.bfloat16)
                  for a in (q, k, v, b))
    want = _jax_fwd(q, k, v, b, False).astype("f4")
    tq, tk, tv, tb = (None if a is None else
                      torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                      for a in (q, k, v, b))
    got = fab.flash_attention_bias(tq, tk, tv, tb, sm_scale=SCALE)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape", [None, (2, 1, 1, 256),
                                        (1, 1, 256, 256), (2, 2, 256, 256)],
                         ids=["none", "key", "shared_full", "full"])
def test_backward_matches_jax_vjp(bias_shape, causal):
    bias = "none" if bias_shape is None else "full"
    q, k, v, b = _inputs(2, bias=bias, bias_shape=bias_shape)
    do = np.random.RandomState(3).randn(*q.shape).astype("f4")
    primals = [jnp.asarray(a) for a in (q, k, v, b) if a is not None]

    def f(*args):
        qq, kk, vv = args[:3]
        return jflash(qq, kk, vv, args[3] if len(args) > 3 else None,
                      sm_scale=SCALE, causal=causal, interpret=True)

    _, vjp = jax.vjp(f, *primals)
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    leaves = [_t(a).requires_grad_(True) for a in (q, k, v, b)
              if a is not None]
    out = fab.flash_attention_bias(
        *leaves[:3], leaves[3] if len(leaves) > 3 else None,
        sm_scale=SCALE, causal=causal)
    got = torch.autograd.grad(out, leaves, _t(do))
    for name, g, w in zip("q k v bias".split(), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD_TOL)


def test_default_scale_is_inverse_sqrt_head_dim():
    q, k, v, b = _inputs(4, S=128, D=128)
    a = fab.flash_attention_bias(*map(_t, (q, k, v, b)))
    want = fab.flash_attention_bias_reference(*map(_t, (q, k, v, b)),
                                              sm_scale=128 ** -0.5)
    np.testing.assert_array_equal(a.numpy(), want.numpy())


def test_fully_masked_sequence_matches_jax_kernel():
    """A sequence whose every key is masked by the bias: the softmax
    still sees its largest score at exp(0), so neither version takes
    the l == 0 guard, and both return the same weights."""
    q, k, v, _ = _inputs(5, S=128, bias="none")
    b = np.zeros((2, 1, 1, 128), "f4")
    b[1] = -1e9
    want = _jax_fwd(q, k, v, b, False)
    got = fab.flash_attention_bias(*map(_t, (q, k, v, b)), sm_scale=SCALE)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_cpu_tensors_never_count_a_launch():
    q, k, v, b = _inputs(6, S=128)
    fab.reset_launch_count()
    got = fab.flash_attention_bias(*map(_t, (q, k, v, b)), sm_scale=SCALE)
    ref = fab.flash_attention_bias_reference(*map(_t, (q, k, v, b)),
                                             sm_scale=SCALE)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert fab.flash_attention_bias.launches == 0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


_GOOD = dict(q=(2, 3, 128, 64), k=(2, 3, 128, 64), v=(2, 3, 128, 64),
             bias=(2, 1, 1, 128))
_BAD_SHAPES = {
    "seq_not_multiple_of_128": dict(q=(2, 3, 100, 64), k=(2, 3, 100, 64),
                                    v=(2, 3, 100, 64), bias=(2, 1, 1, 100)),
    "q_rank": dict(q=(6, 128, 64)),
    "k_heads": dict(k=(2, 4, 128, 64)),
    "v_shape": dict(v=(2, 3, 256, 64)),
    "bias_key_dim": dict(bias=(2, 1, 1, 64)),
    "bias_batch": dict(bias=(3, 1, 1, 128)),
    "bias_rank": dict(bias=(2, 128)),
}


@pytest.mark.parametrize("case", sorted(_BAD_SHAPES))
def test_wrapper_rejects_bad_shapes(case):
    shapes = {**_GOOD, **_BAD_SHAPES[case]}
    with pytest.raises(ValueError):
        fab.flash_attention_bias(*(_meta(*shapes[n])
                                   for n in ("q", "k", "v", "bias")))


_BAD_LAUNCH = {
    "head_dim_32": dict(q=_meta(2, 3, 128, 32), k=_meta(2, 3, 128, 32),
                        v=_meta(2, 3, 128, 32)),
    "float16": dict(q=_meta(2, 3, 128, 64, dtype=torch.float16),
                    k=_meta(2, 3, 128, 64, dtype=torch.float16),
                    v=_meta(2, 3, 128, 64, dtype=torch.float16)),
    "mixed_dtypes": dict(v=_meta(2, 3, 128, 64, dtype=torch.bfloat16)),
    "bias_int": dict(bias=_meta(2, 1, 1, 128, dtype=torch.int32)),
    "not_contiguous": dict(k=_meta(2, 3, 64, 128).transpose(2, 3)),
    "mixed_devices": dict(bias=torch.zeros(2, 1, 1, 128)),
}


@pytest.mark.parametrize("case", sorted(_BAD_LAUNCH))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args = dict(q=_meta(*_GOOD["q"]), k=_meta(*_GOOD["k"]),
                v=_meta(*_GOOD["v"]), bias=_meta(*_GOOD["bias"]))
    args.update(_BAD_LAUNCH[case])
    with pytest.raises(ValueError):
        fab.flash_attention_bias(args["q"], args["k"], args["v"],
                                 args["bias"])


def test_wrapper_refuses_non_cuda_devices():
    """Valid arguments on a device that is neither the CPU nor CUDA: the
    wrapper raises instead of falling back to the plain version."""
    before = fab.flash_attention_bias.launches
    for bias in (_meta(*_GOOD["bias"]), None):
        with pytest.raises(RuntimeError, match="CUDA tensors only"):
            fab.flash_attention_bias(_meta(*_GOOD["q"]), _meta(*_GOOD["k"]),
                                     _meta(*_GOOD["v"]), bias)
    assert fab.flash_attention_bias.launches == before


def test_bias_strides_read_the_natural_shape():
    """The kernel addresses the bias through (b, h, query) element
    strides that are 0 along its broadcast dims."""
    assert fab._bias_strides(None) == (0, 0, 0)
    assert fab._bias_strides(_meta(2, 1, 1, 256)) == (256, 0, 0)
    assert fab._bias_strides(_meta(1, 1, 128, 256)) == (0, 0, 256)
    assert fab._bias_strides(_meta(2, 3, 128, 256)) == (3 * 128 * 256,
                                                        128 * 256, 256)
