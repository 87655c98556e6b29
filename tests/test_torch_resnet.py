"""PyTorch port: static-graph ResNet training, end to end on the CPU.

- The ResNet-50 training program (``resnet50_train_program``, as
  ``bench.py``'s ``bench_resnet`` builds it: lr 0.1, momentum 0.9) built
  by both packages, in float32 and under ``decorate(use_bf16=True)``:
  the same ops (types, slots, attributes) in the same order and the same
  variables, in the main and the startup program (building only: the
  full network is too heavy to train on the CPU in a test).
- A small ResNet of each package's ``_conv_bn`` / ``_bottleneck`` (a
  3x32x32 input, the 7x7 stem and the max pool, one bottleneck a stage
  with a stride-2 downsample, narrow channels, 10 classes) and a
  LeNet-sized conv net (BASELINE config 1's layers), started from the
  JAX package's startup values (``scope_from_numpy``: the packages draw
  random numbers differently) and trained 3 steps with momentum by both
  executors on the same feeds; the small ResNet once more under bf16 AMP.
- The ``uint8_input`` head (``cast`` from uint8, then ``scale``).

Tolerances:
- float32: losses within 1e-4 relative; every parameter, velocity and
  running statistic within 1e-4 of its tensor's largest magnitude.  The
  two run the same float32 arithmetic in other summation orders (about
  1e-6 an op), which batch norm over few values and 3 momentum steps
  amplify; the measured gap is about 1e-5.
- bfloat16 AMP against float32 (the port alone): losses within 2**-4
  relative.  Every convolution and its gradients round their results to
  bfloat16 (2**-8 relative each), through 3 bottlenecks and 3 steps; a
  wrong dtype path (a float32 activation where a bf16 one belongs, a
  lost cast) changes the loss by far more or makes it non-finite.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpkg
from paddle_tpu import layers as jlayers
from paddle_tpu.amp.static_amp import decorate as jdecorate
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.optimizer import MomentumOptimizer as JMomentum
from paddle_tpu.vision import static_models as jmodels
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.amp import decorate as tdecorate
from paddle_tpu_torch.framework import lowering as tlowering
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import scope_from_numpy
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import flash_attention_bias as fab
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import quant_ops as tqo
from paddle_tpu_torch.optimizer import MomentumOptimizer as TMomentum
from paddle_tpu_torch.vision import static_models as tmodels

PACKAGES = {
    "jax": (jpkg, jlayers, jdecorate, jprogram, junique, JMomentum, jmodels),
    "torch": (tpkg, tlayers, tdecorate, tprogram, tunique, TMomentum,
              tmodels),
}
STEPS, LR = 3, 0.05
F32_RTOL = 1e-4
AMP_LOSS_RTOL = 2.0 ** -4


def _describe(prog):
    blk = prog.global_block
    ops = [(op.type, op.inputs, op.outputs, op.attrs) for op in blk.ops]
    var_s = {n: (v.shape, v.dtype, v.persistable, v.stop_gradient,
                 v.is_parameter) for n, v in blk.vars.items()}
    return len(prog.blocks), prog.random_seed, ops, var_s


def _resnet50(which, amp, **kw):
    _pkg, _layers, decorate, prog_mod, unique, _opt, models = \
        PACKAGES[which]
    with unique.guard():
        main, startup, _feeds, loss, opt = models.resnet50_train_program(
            lr=0.1, momentum=0.9, **kw)
        main.random_seed = 1
        with prog_mod.program_guard(main, startup):
            (decorate(opt, use_bf16=True) if amp else opt).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("amp", [True, False], ids=["bf16_amp", "fp32"])
def test_resnet50_program_matches_jax(amp):
    jmain, jstart, _ = _resnet50("jax", amp)
    tmain, tstart, _ = _resnet50("torch", amp)
    for j, t in ((jmain, tmain), (jstart, tstart)):
        jd, td = _describe(j), _describe(t)
        assert jd[:2] == td[:2]
        assert len(jd[2]) == len(td[2])
        for i, (a, b) in enumerate(zip(jd[2], td[2])):
            assert a == b, f"op {i}: {a[0]} vs {b[0]}"
        assert jd[3] == td[3]
    types = [op.type for op in tmain.global_block.ops]
    start = [op.type for op in tstart.global_block.ops]
    assert (types.count("conv2d"), types.count("batch_norm"),
            types.count("momentum")) == (53, 53, 161)
    assert start.count("gaussian_random") == 53
    assert start.count("uniform_random") == 1
    if amp:   # the program chip_smoke.py trains on the card
        assert len(types) == 646 and types.count("cast") == 57
    # every op type of both programs has a lowering in the port (the
    # unregistered *_grad ones take the generic gradient)
    for t in set(types) | set(start):
        assert tlowering.get_lowering(t)


def _small_resnet(which, amp=False):
    """3x32x32 -> the stem (7x7 stride 2, max pool) -> one bottleneck a
    stage (stride 2 and a downsample from the second) -> global average
    pool -> fc(10), built from the package's own blocks."""
    _pkg, layers, decorate, prog_mod, unique, momentum, models = \
        PACKAGES[which]
    with unique.guard():
        main, startup = prog_mod.Program(), prog_mod.Program()
        main.random_seed = 3
        with prog_mod.program_guard(main, startup):
            img = layers.data("image", [3, 32, 32])
            label = layers.data("label", [1], dtype="int64")
            y = models._conv_bn(img, 8, 7, stride=2, act="relu",
                                name="stem")
            y = layers.pool2d(y, 3, "max", 2, pool_padding=1)
            for stage, ch in enumerate((4, 8, 8)):
                y = models._bottleneck(y, ch, 2 if stage else 1,
                                       downsample=True, name=f"s{stage}")
            y = layers.pool2d(y, global_pooling=True, pool_type="avg")
            logits = layers.fc(y, 10, name="fc")
            loss = layers.mean(layers.softmax_with_cross_entropy(logits,
                                                                 label))
            opt = momentum(LR, 0.9)
            (decorate(opt, use_bf16=True) if amp else opt).minimize(loss)
    return main, startup, loss


def _lenet(which):
    """BASELINE config 1's layers: conv 5x5 (+relu), max pool, conv 5x5,
    max pool, fc 120, fc 84, fc 10, momentum."""
    _pkg, layers, _decorate, prog_mod, unique, momentum, _models = \
        PACKAGES[which]
    with unique.guard():
        main, startup = prog_mod.Program(), prog_mod.Program()
        main.random_seed = 4
        with prog_mod.program_guard(main, startup):
            img = layers.data("image", [1, 28, 28])
            label = layers.data("label", [1], dtype="int64")
            c1 = layers.conv2d(img, 6, 5, padding=2, act="relu")
            p1 = layers.pool2d(c1, 2, "max", 2)
            c2 = layers.conv2d(p1, 16, 5, act="relu")
            p2 = layers.pool2d(c2, 2, "max", 2)
            f1 = layers.fc(p2, 120, act="relu")
            f2 = layers.fc(f1, 84, act="relu")
            logits = layers.fc(f2, 10)
            loss = layers.mean(layers.softmax_with_cross_entropy(logits,
                                                                 label))
            momentum(LR / 5, 0.9, use_nesterov=True).minimize(loss)
    return main, startup, loss


BUILDS = {"small_resnet": (_small_resnet, (3, 32, 32)),
          "lenet": (_lenet, (1, 28, 28))}


def _feed(shape, seed=0, batch=8):
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(batch, *shape).astype("f4"),
            "label": rs.randint(0, 10, (batch, 1)).astype("int32")}


def _jax_init(startup):
    scope = jpkg.framework.Scope()
    jpkg.Executor(jpkg.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.asarray(scope.get_var(v.name))
            for v in startup.global_block.vars.values() if v.persistable}


def _train_jax(main, loss, init, feed):
    scope = jpkg.framework.Scope()
    for n, a in init.items():
        scope.set_var(n, a)
    exe = jpkg.Executor(jpkg.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).ravel()[0])
              for _ in range(STEPS)]
    return losses, {n: np.asarray(scope.get_var(n)).astype("f4")
                    for n in init}


def _train_torch(main, loss, init, feed, trace=None):
    scope = scope_from_numpy(init, device="cpu")
    exe = tpkg.Executor(tpkg.CPUPlace())
    losses = []
    for _ in range(STEPS):
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        losses.append(float(out.ravel()[0]))
        if trace is not None:
            trace.append({n: scope.get_var(n).clone() for n in trace[0]})
    return losses, {n: scope.get_var(n).float().numpy() for n in init}


def _launches():
    return (fab.flash_attention_bias.launches,
            [f.launches for f in tfa.KERNEL_WRAPPERS],
            tqo.dequant_matmul.launches,
            tpa.paged_decode_attention.launches,
            tpa.paged_chunk_attention.launches)


@pytest.mark.parametrize("model", sorted(BUILDS))
def test_float32_training_matches_jax(model):
    """3 momentum steps: losses, parameters, velocities and running
    statistics of the port against the JAX package's; the running
    statistics move every step (the executor writes ``MeanOut`` /
    ``VarianceOut`` back to the scope), and no hand-written kernel runs."""
    build, shape = BUILDS[model]
    jmain, jstart, jloss = build("jax")
    tmain, _tstart, tloss = build("torch")
    init = _jax_init(jstart)
    feed = _feed(shape)
    before = _launches()
    stats = {n: torch.from_numpy(init[n].copy()) for n in sorted(init)
             if ".gv" in n}
    trace = [stats]
    want_losses, want = _train_jax(jmain, jloss, init, feed)
    got_losses, got = _train_torch(tmain, tloss, init, feed, trace)
    assert _launches() == before
    np.testing.assert_allclose(got_losses, want_losses, rtol=F32_RTOL)
    assert got_losses[-1] < got_losses[0]
    assert set(got) == set(want)
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= F32_RTOL * scale, (n, err, scale)
    if model == "small_resnet":
        assert len(stats) == 2 * 13     # mean and variance of 13 norms
        for a, b in zip(trace, trace[1:]):
            assert all(not torch.equal(a[n], b[n]) for n in stats)
    velocities = [n for n in want if "velocity" in n]
    assert velocities and all(np.abs(got[n]).max() > 0 for n in velocities)


def test_small_resnet_explicit_gradients_match_generic(monkeypatch):
    """The same 3 steps in the port with ``conv2d_grad`` and
    ``batch_norm_grad`` taken away from the registry, so that both replay
    their forward under autograd: the losses and the state after agree
    with the explicit gradients' run within the float32 tolerance."""
    main, startup, loss = _small_resnet("jax")
    init = _jax_init(startup)
    tmain, _s, tloss = _small_resnet("torch")
    feed = _feed((3, 32, 32), seed=1)
    explicit_losses, explicit = _train_torch(tmain, tloss, init, feed)
    with monkeypatch.context() as m:
        for t in ("conv2d_grad", "batch_norm_grad"):
            m.delitem(tlowering.LOWERINGS, t)
        generic_losses, generic = _train_torch(tmain, tloss, init, feed)
    np.testing.assert_allclose(explicit_losses, generic_losses,
                               rtol=F32_RTOL)
    for n in generic:
        scale = max(float(np.abs(generic[n]).max()), 1e-30)
        assert float(np.abs(explicit[n] - generic[n]).max()) \
            <= F32_RTOL * scale, n


def test_small_resnet_bf16_amp_on_the_cpu():
    """bf16 AMP in the port: the convolutions and the activations between
    them run in bfloat16 (batch norm's statistics and the running stats,
    the parameters and the loss in float32); finite losses that fall and
    stay within the bfloat16 bound of the float32 run's."""
    main, startup, loss = _small_resnet("jax")
    init = _jax_init(startup)
    feed = _feed((3, 32, 32), seed=2)
    results = {}
    for amp in (False, True):
        tmain, _s, tloss = _small_resnet("torch", amp=amp)
        results[amp] = _train_torch(tmain, tloss, init, feed)
    f32_losses, _ = results[False]
    amp_losses, amp_state = results[True]
    assert all(np.isfinite(amp_losses)) and amp_losses[-1] < amp_losses[0]
    np.testing.assert_allclose(amp_losses, f32_losses, rtol=AMP_LOSS_RTOL)
    # the conv's output is bf16 under AMP, and batch norm keeps it so
    tmain, _s, tloss = _small_resnet("torch", amp=True)
    scope = scope_from_numpy(init, device="cpu")
    fetch = ["stem_conv.tmp_0", "stem_bn.tmp_3", "stem_bn.tmp_1"]
    outs = tpkg.Executor(tpkg.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch, scope=scope, return_numpy=False)
    assert [o.dtype for o in outs] == [torch.bfloat16, torch.bfloat16,
                                       torch.float32]
    # the parameters, velocities and running statistics stay float32
    assert all(scope.get_var(n).dtype == torch.float32 for n in init)
    assert all(np.isfinite(v).all() for v in amp_state.values())


def test_uint8_input_head_matches_jax():
    """``uint8_input=True``: the image arrives as uint8 and the program's
    head casts it to float32 and scales it to [-1, 1] (x / 127.5 - 1);
    the head's output and the stem convolution after it (the program cut
    there) agree with the JAX package's (float32 rule), on a 3x32x32
    image."""
    kw = dict(uint8_input=True, img_shape=(3, 32, 32), class_num=10)
    jmain, _jstart, _ = _resnet50("jax", False, **kw)
    tmain, _tstart, _ = _resnet50("torch", False, **kw)
    assert _describe(jmain)[2] == _describe(tmain)[2]
    head = [op.type for op in tmain.global_block.ops[:3]]
    assert head == ["cast", "scale", "conv2d"]
    img = tmain.global_block.ops[1].outputs["Out"][0]
    conv = tmain.global_block.ops[2].outputs["Output"][0]
    for prog in (jmain, tmain):   # run the head and the stem conv only
        del prog.global_block.ops[3:]
        prog._bump()
    rs = np.random.RandomState(5)
    w = tmain.global_block.ops[2].inputs["Filter"][0]
    init = {w: rs.randn(64, 3, 7, 7).astype("f4") * 0.1}
    feed = {"image": rs.randint(0, 256, (2, 3, 32, 32)).astype("uint8"),
            "label": rs.randint(0, 10, (2, 1)).astype("int32")}
    scope = jpkg.framework.Scope()
    for n, a in init.items():
        scope.set_var(n, a)
    want = jpkg.Executor(jpkg.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[img, conv], scope=scope)
    got = tpkg.Executor(tpkg.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[img, conv],
        scope=scope_from_numpy(init, device="cpu"))
    np.testing.assert_array_equal(
        got[0], feed["image"].astype("f4") * np.float32(1 / 127.5) - 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
