"""PyTorch port: quantization-aware training and activation PTQ
(``paddle_tpu_torch/slim/quantization.py``) against the JAX package's
``paddle_tpu/slim/quantization.py`` on the CPU, on the LeNet-style net of
``tests/test_quantization.py``.

- QAT: the transform pass emits the same program (op for op, var names
  included) in both packages; both train from the JAX startup's values
  (``scope_from_numpy``) on the same seeded prototype batches.  Step 1's
  loss and the moving-average scales after it agree within 1e-5
  relative: the convolution and the fc sum in other orders in the two
  packages (float32), and those ulps reach the scales, which are a mean
  of abs-maxes.  Later steps are not held to each other: a one-ulp
  difference before a rounding moves a value by a whole quantization
  step, so two float32 QAT trajectories part (held instead: the loss
  falls in both, by the JAX test's factor).
- ``clone(for_test=True)`` freezes the scales (``is_test`` set); the
  frozen program leaves the scope's scales as they are.
- PTQ emits the same quantized program as the JAX package, with the
  calibrated scales equal to 1e-6 relative (abs-maxes of activations
  computed in other summation orders), and its outputs track float32
  within the JAX test's int8 bound; the port's outputs match JAX's
  quantized program within 1e-4 of the logits' scale (a calibrated
  scale one ulp apart can move an activation by one quantization step).
- QAT -> ``save_inference_model`` -> ``Predictor`` serves the frozen
  graph within the JAX test's bound (1e-4 relative, 1e-5 absolute).
"""
from importlib import import_module

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_fleet_parity import build_both, run_both

RTOL = 1e-5
MA_TYPE = "fake_quantize_dequantize_moving_average_abs_max"


def _slim(p):
    return import_module(p.__name__ + ".slim")


def _lenet(p, qat=True, with_loss=True):
    layers = p.layers
    main, startup = p.framework.Program(), p.framework.Program()
    main.random_seed = 3
    with p.framework.program_guard(main, startup):
        img = layers.data("img", shape=[1, 8, 8], dtype="float32")
        h = layers.conv2d(img, num_filters=4, filter_size=3, act="relu")
        h = layers.pool2d(h, pool_size=2, pool_type="max")
        h = layers.fc(h, size=4)
        if not with_loss:
            return main, startup, [h]
        lbl = layers.data("lbl", shape=[1], dtype="int32")
        loss = layers.mean(layers.softmax_with_cross_entropy(h, lbl))
        if qat:
            _slim(p).quant_aware(main, startup)
        p.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, [loss]


def _batches(n_batches, seed=0, n=32):
    rs = np.random.RandomState(seed)
    protos = rs.randn(4, 1, 8, 8).astype("f4")
    out = []
    for _ in range(n_batches):
        c = rs.randint(0, 4, n)
        x = protos[c] + 0.1 * rs.randn(n, 1, 8, 8).astype("f4")
        out.append({"img": x.astype("f4"),
                    "lbl": c.reshape(-1, 1).astype("i4")})
    return out


def _ops(prog):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()})
            for op in prog.global_block.ops]


def _scale_names(main):
    return [op.output("OutScale")[0] for op in main.global_block.ops
            if op.type == MA_TYPE]


def test_qat_program_equals_jax_op_for_op():
    (jm, js, _), (tm, ts, _) = build_both(_lenet)
    assert _ops(tm) == _ops(jm)
    assert _ops(ts) == _ops(js)
    fwd = [op.type for op in tm.global_block.ops
           if op.type.startswith("fake_") and not op.type.endswith("_grad")]
    assert fwd == ["fake_quantize_dequantize_moving_average_abs_max",
                   "fake_channel_wise_quantize_dequantize_abs_max"] * 2


def test_qat_step_one_and_scales_match_jax_and_both_train():
    (jm, js, _), (tm, ts, tf) = build_both(_lenet)
    scales = _scale_names(tm)
    assert len(scales) == 2
    feeds = _batches(40)
    want, got, jscope, tscope = run_both((jm, js), (tm, ts), feeds[:1],
                                         tf + scales)
    for g, w in zip(got[0], want[0]):   # the loss, then the scales
        np.testing.assert_allclose(g, w, rtol=RTOL)
    assert all(v[0] != 1.0 for v in got[0][1:])   # moved off their init
    want, got, _, _ = run_both((jm, js), (tm, ts), feeds, tf)
    jl = [w[0].item() for w in want]
    tl = [g[0].item() for g in got]
    assert jl[0] / jl[-1] > 2.0 and tl[0] / tl[-1] > 2.0, (jl, tl)


def test_qat_moving_average_scales_keep_adapting():
    (_, _, _), (tm, ts, tf) = build_both(_lenet)
    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(ts, scope=scope)
    name = _scale_names(tm)[0]
    feed = _batches(1, seed=1)[0]
    exe.run(tm, feed=feed, fetch_list=tf, scope=scope)
    v0 = scope.get_var(name).numpy().copy()
    exe.run(tm, feed=feed, fetch_list=tf, scope=scope)
    v1 = scope.get_var(name).numpy()
    assert not np.allclose(v0, 1.0) and not np.allclose(v0, v1)


def test_clone_for_test_freezes_the_scales():
    (_, _, _), (tm, ts, tf) = build_both(_lenet)
    test_prog = tm.clone(for_test=True)
    ma = [op for op in test_prog.global_block.ops if op.type == MA_TYPE]
    assert ma and all(op.attr("is_test") is True for op in ma)
    assert all(op.attr("is_test") is False for op in tm.global_block.ops
               if op.type == MA_TYPE)
    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(ts, scope=scope)
    exe.run(tm, feed=_batches(1)[0], fetch_list=tf, scope=scope)
    before = {n: scope.get_var(n).clone() for n in _scale_names(tm)}
    logits = [op for op in test_prog.global_block.ops
              if op.type == "softmax_with_cross_entropy"][0]
    exe.run(test_prog, feed={"img": _batches(1, seed=2)[0]["img"]},
            fetch_list=logits.input("Logits"), scope=scope, use_prune=True)
    for n, v in before.items():
        assert scope.get_var(n).equal(v)


def _ptq(p, infer, scope_and_exe, calib):
    exe, scope = scope_and_exe
    ptq = _slim(p).PostTrainingQuantization(
        exe, infer, feed_list=["img"], fetch_list=[], data_loader=calib,
        scope=scope, batch_nums=4)
    return ptq, ptq.quantize()


def test_ptq_program_and_scales_match_jax():
    (jm, js, jf), (tm, ts, tf) = build_both(
        lambda p: _lenet(p, with_loss=False))
    jinfer, tinfer = jm.clone(for_test=True), tm.clone(for_test=True)
    calib = [{"img": b["img"]} for b in _batches(4, seed=2)]
    jexe = J.Executor(J.CPUPlace())
    jscope = J.framework.Scope()
    jexe.run(js, scope=jscope)
    from paddle_tpu_torch.framework.scope import scope_from_numpy

    init = {v.name: np.asarray(jscope.get_var(v.name))
            for v in js.global_block.vars.values() if v.persistable}
    tscope = scope_from_numpy(init, device="cpu")
    texe = T.Executor(T.CPUPlace())
    with J.framework.unique_name.guard():
        jptq, jq = _ptq(J, jinfer, (jexe, jscope), calib)
    with T.framework.unique_name.guard():
        tptq, tq = _ptq(T, tinfer, (texe, tscope), calib)
    assert sorted(tptq._act_scales) == sorted(jptq._act_scales)
    for n, v in jptq._act_scales.items():
        assert tptq._act_scales[n] == pytest.approx(v, rel=1e-6)
    strip = [(t, i, o) for t, i, o in _ops(tq)]
    assert strip == _ops(jq)
    x = _batches(1, seed=5, n=16)[0]["img"]
    out = tf[0].name
    ref = texe.run(tinfer, feed={"img": x}, fetch_list=[out],
                   scope=tscope)[0]
    got = texe.run(tq, feed={"img": x}, fetch_list=[out], scope=tscope)[0]
    theirs = np.asarray(jexe.run(jq, feed={"img": x}, fetch_list=[out],
                                 scope=jscope)[0])
    denom = max(np.abs(ref).max(), 1e-6)
    assert np.abs(ref - got).max() / denom < 0.1
    assert np.abs(got - theirs).max() / denom < 1e-4


def test_qat_freeze_export_predictor_roundtrip(tmp_path):
    """Train with the pass -> clone(for_test=True) -> save_inference_model
    -> Predictor (the port's, on the CPU) matches the frozen program."""
    from paddle_tpu_torch.fluid.io import save_inference_model
    from paddle_tpu_torch.inference import Config, Predictor

    (_, _, _), (tm, ts, tf) = build_both(_lenet)
    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(ts, scope=scope)
    for feed in _batches(10, seed=7):
        exe.run(tm, feed=feed, fetch_list=tf, scope=scope)
    test_prog = tm.clone(for_test=True)
    logits = [op for op in test_prog.global_block.ops
              if op.type == "softmax_with_cross_entropy"][0] \
        .input("Logits")[0]
    x = _batches(1, seed=8, n=8)[0]["img"]
    ref = exe.run(test_prog, feed={"img": x}, fetch_list=[logits],
                  scope=scope, use_prune=True)[0]
    path = str(tmp_path / "qat_model")
    with T.fluid.scope_guard(scope):
        save_inference_model(path, ["img"],
                             [test_prog.global_block.var(logits)], exe,
                             main_program=test_prog)
    config = Config(path)
    config.disable_gpu()
    pred = Predictor(config)
    got = np.asarray(pred.run({"img": x})[0])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    types = [op.type for op in pred._program.global_block.ops]
    assert MA_TYPE in types and \
        "fake_channel_wise_quantize_dequantize_abs_max" in types
