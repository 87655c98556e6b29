"""PyTorch port: weight-only quantization and the dequant-fused matmul
(``paddle_tpu_torch/ops/quant_ops.py``, B7's plain version on the CPU),
held against the JAX package's ``paddle_tpu/ops/quant_ops.py``.

The same numpy inputs (from a seed) go through both packages:

- ``quantize_weight`` gives carriers and scales equal BIT FOR BIT in int8
  and fp8-e4m3 (round half to even, and a round-to-nearest-even cast to
  float8, in both), so ``dequantize_weight`` agrees exactly too;
- ``dequant_matmul`` on CPU tensors (the plain version) against the JAX
  Pallas kernel in interpret mode on a shape its tiles divide, and against
  the JAX reference on ragged shapes (where the JAX package falls back to
  it): per element within 2**-20 of sum_k |x[m, k] * w[k, n]| (float32
  summation in two orders over K <= 3072 terms; the weights carry a
  40x outlier channel, so the bound follows each element's scale);
- the ``dequant_matmul`` op's lowering, every branch (``mul`` flattening,
  ``matmul``/``matmul_v2``, transposes, ``alpha``, non-2-D weights), run
  through each package's executor: within 1e-5 absolute (K = 24, O(1)
  terms).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpkg
from paddle_tpu.framework import program as jprogram
from paddle_tpu.monitor import stat_get as jstat_get
from paddle_tpu.ops import quant_ops as jq
import paddle_tpu_torch as tpkg
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework.scope import to_numpy, to_tensor
from paddle_tpu_torch.monitor import stat_get as tstat_get
from paddle_tpu_torch.ops import quant_ops as tq

TOL = 1e-5
PKG = {"jax": (jpkg, jprogram), "torch": (tpkg, tprogram)}


def _bits(a):
    """The raw bytes of a carrier or scale (numpy, jax or torch)."""
    if isinstance(a, torch.Tensor):
        a = to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


def _assert_matmul_close(ours, theirs, x, q, s):
    """The bound of the module docstring: float32 summation order."""
    w = np.asarray(tq.dequantize_weight(_carrier(q), torch.from_numpy(
        np.array(s)), 1))
    scale = np.abs(np.asarray(x, np.float64)) @ np.abs(w.astype(np.float64))
    excess = np.abs(ours.astype(np.float64) - theirs) - 2.0 ** -20 * scale
    assert ours.shape == theirs.shape and excess.max() <= 0, excess.max()


def _weight(rs, k, n):
    w = rs.randn(k, n).astype("f4")
    w[:, 0] *= 40.0     # an outlier channel
    w[:, 1] = 0.0       # an all-zero channel
    return w


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quantize_weight_is_bit_equal_to_jax(mode):
    rs = np.random.RandomState(0)
    for k, n in ((64, 48), (300, 70), (768, 2)):
        w = _weight(rs, k, n)
        jq_, js = jq.quantize_weight(w, 1, mode)
        tq_, ts = tq.quantize_weight(torch.from_numpy(w), 1, mode)
        assert str(tq_.dtype) == ("torch.int8" if mode == "int8"
                                  else "torch.float8_e4m3fn")
        assert ts.dtype == torch.float32
        assert np.array_equal(_bits(tq_), _bits(jq_))
        assert np.array_equal(_bits(ts), _bits(js))
    # numpy in, per-row channels (axis 0)
    w = _weight(rs, 32, 16)
    jq_, js = jq.quantize_weight(w, 0, mode)
    tq_, ts = tq.quantize_weight(w, 0, mode)
    assert np.array_equal(_bits(tq_), _bits(jq_))
    assert np.array_equal(_bits(ts), _bits(js))


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_dequantize_weight_matches_jax(mode):
    rs = np.random.RandomState(1)
    w = _weight(rs, 96, 40)
    q, s = tq.quantize_weight(torch.from_numpy(w), 1, mode)
    ours = tq.dequantize_weight(q, s, 1).numpy()
    theirs = np.asarray(jq.dequantize_weight(*jq.quantize_weight(w, 1, mode),
                                             1))
    assert np.array_equal(ours, theirs)
    err = np.abs(ours - w).max(axis=0) / np.abs(w).max(axis=0).clip(1e-30)
    assert err.max() < (0.5 / 127 + 1e-6 if mode == "int8" else 2 ** -4)
    bf = tq.dequantize_weight(q, s, 1, torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_scale_clamp_is_per_slice_not_global():
    """An all-zero output channel gets a CLAMPED scale of its own and
    dequantizes to exact zeros, while its neighbours keep real scales
    (the JAX package's per-slice bugfix,
    ``tests/test_quant_inference.py:54-86``, weight half)."""
    rs = np.random.RandomState(0)
    w = rs.randn(16, 8).astype("f4")
    w[:, 3] = 0.0
    for mode in ("int8", "fp8_e4m3"):
        q, s = tq.quantize_weight(torch.from_numpy(w), 1, mode)
        s = s.numpy()
        assert np.isfinite(s).all()
        assert s[3] == np.float32(tq.SCALE_EPS)
        assert s[2] > 1e-4
        wd = tq.dequantize_weight(q, torch.from_numpy(s), 1).numpy()
        assert np.all(wd[:, 3] == 0.0) and np.isfinite(wd).all()
    assert tq.SCALE_EPS == jq.SCALE_EPS
    assert (tq.INT8_QMAX, tq.FP8_E4M3_MAX, tq.WEIGHT_QUANT_MODES) == \
        (jq.INT8_QMAX, jq.FP8_E4M3_MAX, jq.WEIGHT_QUANT_MODES)


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_plain_version_matches_the_jax_kernel_in_interpret_mode(mode):
    """256 x 512 x 256: a shape the Pallas tiles (256 / 512 / 256)
    divide, so the JAX call runs its kernel (interpret mode)."""
    rs = np.random.RandomState(2)
    x = rs.randn(256, 512).astype("f4")
    q, s = jq.quantize_weight(_weight(rs, 512, 256), 1, mode)
    n0 = jstat_get("quant_pallas_fallback_shape")
    theirs = np.asarray(jq.dequant_matmul(jnp.asarray(x), q, s,
                                          use_pallas="always",
                                          interpret=True))
    assert jstat_get("quant_pallas_fallback_shape") == n0
    launches = tq.dequant_matmul.launches
    ours = tq.dequant_matmul(torch.from_numpy(x), _carrier(q),
                             torch.from_numpy(np.array(s)),
                             use_pallas="always").numpy()
    assert tq.dequant_matmul.launches == launches   # CPU: no kernel
    _assert_matmul_close(ours, theirs, x, q, s)


def _carrier(q):
    """A JAX carrier as a torch tensor (float8 through ``to_tensor``)."""
    return to_tensor(np.asarray(q))


@pytest.mark.parametrize("shape", [(100, 300, 70), (32, 768, 2),
                                   (128, 3072, 768)])
def test_plain_version_matches_jax_on_ragged_shapes(shape):
    """Shapes the Pallas tiles do not divide: the JAX package falls back
    to its reference (counted); the port's plain version agrees."""
    m, k, n = shape
    rs = np.random.RandomState(3)
    x = rs.randn(m, k).astype("f4")
    for mode in ("int8", "fp8_e4m3"):
        q, s = jq.quantize_weight(_weight(rs, k, n), 1, mode)
        theirs = np.asarray(jq.dequant_matmul(jnp.asarray(x), q, s,
                                              use_pallas="always",
                                              interpret=True))
        ours = tq.dequant_matmul(torch.from_numpy(x), _carrier(q),
                                 torch.from_numpy(np.array(s))).numpy()
        _assert_matmul_close(ours, theirs, x, q, s)


def test_bfloat16_x_and_out_dtype():
    """bf16 activations: both packages sum in float32 and round once, so
    the outputs agree within one bfloat16 step; ``out_dtype`` picks the
    result's type."""
    import ml_dtypes

    rs = np.random.RandomState(4)
    x = rs.randn(64, 96).astype("f4").astype(ml_dtypes.bfloat16)
    q, s = jq.quantize_weight(_weight(rs, 96, 40), 1, "int8")
    theirs = np.asarray(jq.dequant_matmul(jnp.asarray(x), q, s),
                        dtype=np.float32)
    tx = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    ours = tq.dequant_matmul(tx, _carrier(q), torch.from_numpy(
        np.array(s)))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), theirs,
                               rtol=2 ** -7, atol=TOL)
    f32 = tq.dequant_matmul(tx, _carrier(q), torch.from_numpy(np.array(s)),
                            out_dtype=torch.float32)
    want = np.asarray(jq.dequant_matmul(jnp.asarray(x), q, s,
                                        out_dtype=jnp.float32))
    assert f32.dtype == torch.float32
    _assert_matmul_close(f32.numpy(), want, x.astype("f4"), q, s)


def test_wrapper_checks_and_counts():
    x = torch.randn(8, 16)
    q, s = tq.quantize_weight(torch.randn(16, 4), 1, "int8")
    with pytest.raises(ValueError, match="do not chain"):
        tq.dequant_matmul(torch.randn(8, 15), q, s)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        tq.dequant_matmul(x[None], q, s)
    with pytest.raises(ValueError, match="use_pallas"):
        tq.dequant_matmul(x, q, s, use_pallas="sometimes")
    # what the launch path refuses, checked before any launch
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tq._check_launch(x.double(), q, s, torch.float64)
    with pytest.raises(ValueError, match="carrier must be int8"):
        tq._check_launch(x, q.to(torch.int16), s, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        tq._check_launch(torch.randn(16, 8).t(), q, s, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        tq._check_launch(x, q, s, torch.float32)
    before = tq.dequant_matmul.launches
    tq.dequant_matmul(x, q, s)
    assert tq.dequant_matmul.launches == before
    tq.reset_launch_count()
    assert tq.dequant_matmul.launches == 0


def test_resolve_quant_mode_and_quality_delta(monkeypatch):
    for mode in ("int8", "fp8_e4m3"):
        assert tq.resolve_quant_mode(mode) == jq.resolve_quant_mode(mode) \
            == mode
    for bad in ("int4", "", "fp8"):
        with pytest.raises(ValueError, match="unknown weight-quant mode"):
            tq.resolve_quant_mode(bad)
    # a torch without float8 degrades loudly, as the JAX package does
    n0 = tstat_get("quant_fp8_unavailable")
    monkeypatch.delattr(torch, "float8_e4m3fn")
    assert tq.resolve_quant_mode("fp8_e4m3") == "int8"
    assert tstat_get("quant_fp8_unavailable") == n0 + 1
    monkeypatch.undo()
    rs = np.random.RandomState(5)
    ref = rs.randn(6, 10).astype("f4")
    q = ref + rs.randn(6, 10).astype("f4") * 0.3
    theirs = jq.quant_quality_delta(q, ref)
    ours = tq.quant_quality_delta(torch.from_numpy(q), ref)
    assert ours == theirs
    assert tstat_get("quant_quality_top1_agreement_ppm") == \
        int(ours["top1_agreement"] * 1e6)
    with pytest.raises(ValueError, match="logit shapes differ"):
        tq.quant_quality_delta(q[:3], ref)


# -- the dequant_matmul op, every branch of the lowering ------------------

# (label, attrs, x shape, weight shape, weight axis)
LOWERING_CASES = [
    ("mul_flatten", dict(orig_type="mul", x_num_col_dims=2,
                         y_num_col_dims=1), (2, 5, 24), (24, 12), 1),
    ("matmul_v2_2d", dict(orig_type="matmul_v2"), (7, 24), (24, 12), 1),
    # a dygraph Linear's 3-D input: B7 over the flattened rows
    ("matmul_v2_batched_x", dict(orig_type="matmul_v2"), (2, 5, 24),
     (24, 12), 1),
    ("matmul_alpha_batched", dict(orig_type="matmul", alpha=0.5),
     (2, 5, 24), (24, 12), 1),
    ("matmul_transpose_x", dict(orig_type="matmul", transpose_X=True),
     (24, 7), (24, 12), 1),
    ("matmul_v2_trans_y", dict(orig_type="matmul_v2", trans_y=True),
     (7, 24), (12, 24), 0),
    ("matmul_v2_stacked_w", dict(orig_type="matmul_v2"), (3, 7, 24),
     (3, 24, 12), 2),
]


def _run_dequant_op(which, attrs, x, q, s):
    pkg, program = PKG[which]
    main = program.Program()
    blk = main.global_block
    blk.create_var(name="x", shape=x.shape, dtype="float32")
    blk.create_var(name="q", shape=q.shape, dtype="int8", persistable=True)
    blk.create_var(name="s", shape=s.shape, dtype="float32",
                   persistable=True)
    blk.create_var(name="out", dtype="float32")
    blk.append_op("dequant_matmul",
                  {"X": ["x"], "Y": ["q"], "Scale": ["s"]},
                  {"Out": ["out"]}, attrs)
    scope = pkg.framework.Scope()
    scope.set_var("q", q)
    scope.set_var("s", s)
    exe = pkg.Executor(pkg.CPUPlace())
    return np.asarray(exe.run(main, feed={"x": x}, fetch_list=["out"],
                              scope=scope)[0])


@pytest.mark.parametrize("case", LOWERING_CASES, ids=lambda c: c[0])
def test_lowering_branches_match_jax(case):
    _label, attrs, xs, ws, axis = case
    rs = np.random.RandomState(6)
    x = rs.randn(*xs).astype("f4")
    w = rs.randn(*ws).astype("f4")
    for mode in ("int8", "fp8_e4m3"):
        q, s = jq.quantize_weight(w, axis, mode)
        q, s = np.asarray(q), np.asarray(s)
        attrs = dict(attrs, weight_axis=axis, mode=mode)
        theirs = _run_dequant_op("jax", attrs, x, q, s)
        ours = _run_dequant_op("torch", attrs, x, q, s)
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)
