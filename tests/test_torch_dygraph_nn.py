"""PyTorch port: the dygraph ``nn`` layers and functions and
``amp.auto_cast`` against the JAX package's, on the CPU (the optimizers
and ``GradScaler`` are in ``test_torch_dygraph_optimizer.py``).

Each layer is built by both packages, the JAX one's ``state_dict()``
carried across (``dygraph.state_dict_from_numpy``: the packages draw
random numbers differently), then both run the same seeded input: the
outputs, every parameter's gradient and the buffers after the step are
compared (``torch_dygraph_parity``: float32 within 1e-5 of the JAX
result's largest magnitude).  ``auto_cast``: the dtype of each op's result
equals the JAX package's (white ops bfloat16, black float32, gray ones
following their inputs) and the values agree within 2**-6 of the largest
magnitude (both round each white op's result to bfloat16, 2**-8 a value,
at summation orders that can cross a rounding boundary, through a few
ops); the gradients reach the float32 parameters in float32.
"""
import numpy as np
import pytest
import torch

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, check, pair, to_numpy)

rs = np.random.RandomState(7)
IMG = rs.randn(2, 3, 9, 9).astype("f4")
VEC = rs.randn(4, 6).astype("f4")
BF16_TOL = 2.0 ** -6


def run_layer(make, x, train=True, rtol=1e-5, **kw):
    jl, tl = pair(make)
    if not train:
        jl.eval(), tl.eval()
    check(lambda v: jl(v, **kw), lambda v: tl(v, **kw), x, rtol=rtol)
    for (n, a), (_, b) in zip(jl.named_parameters(), tl.named_parameters()):
        if a.grad is not None or b.grad is not None:
            assert_close(to_numpy(a.grad), to_numpy(b.grad), rtol, n)
    for (n, a), (_, b) in zip(jl.named_buffers(), tl.named_buffers()):
        assert_close(to_numpy(a), to_numpy(b), rtol, n)
        assert b._value.grad_fn is None
    return jl, tl


def test_vector_layers():
    for make in (lambda p: p.nn.Linear(6, 5),
                 lambda p: p.nn.Sequential(p.nn.Linear(6, 5), p.nn.ReLU(),
                                           p.nn.Linear(5, 2, bias_attr=False)),
                 lambda p: p.nn.LayerNorm(6),
                 lambda p: p.nn.BatchNorm1D(6)):
        run_layer(make, VEC)


@pytest.mark.parametrize("make", [
    lambda p: p.nn.Conv2D(3, 4, 3, stride=2, padding=1),
    lambda p: p.nn.Conv2D(3, 6, 3, groups=3, bias_attr=False, padding="SAME"),
    lambda p: p.nn.Sequential(p.nn.Conv2D(3, 4, 1, bias_attr=False),
                              p.nn.BatchNorm2D(4),
                              p.nn.ReLU(), p.nn.MaxPool2D(3, 2, 1)),
    lambda p: p.nn.Sequential(p.nn.AvgPool2D(2, 2), p.nn.AdaptiveAvgPool2D(
        (2, 3)), p.nn.AdaptiveMaxPool2D(1), p.nn.Flatten()),
], ids=["conv_stride_pad", "conv_groups_same", "conv_bn_relu_pool",
        "pools_flatten"])
def test_image_layers(make):
    run_layer(make, IMG)


def test_batch_norm_eval_uses_running_statistics():
    jl, tl = run_layer(lambda p: p.nn.BatchNorm2D(3), IMG)   # one step
    jl.eval(), tl.eval()
    check(jl, tl, IMG * 2 + 1)


def test_activation_layers():
    names = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "LeakyReLU", "ELU",
             "SELU", "CELU", "Hardswish", "Hardsigmoid", "Hardtanh",
             "Hardshrink", "Softshrink", "Softplus", "Softsign", "Swish",
             "Silu", "Mish", "Tanhshrink", "ThresholdedReLU", "LogSigmoid",
             "LogSoftmax", "Softmax"]
    for n in names:
        check(lambda v, n=n: getattr(J.nn, n)()(v),
              lambda v, n=n: getattr(T.nn, n)()(v), VEC * 3)
    check(lambda v: J.nn.GELU(approximate=True)(v),
          lambda v: T.nn.GELU(approximate=True)(v), VEC)
    check(lambda v: J.nn.Maxout(2)(v), lambda v: T.nn.Maxout(2)(v), IMG[:, :2])
    run_layer(lambda p: p.nn.PReLU(3, 0.1), IMG)


def test_embedding_dropout_pad_containers():
    ids = rs.randint(0, 10, (3, 4)).astype("int64")
    jl, tl = pair(lambda p: p.nn.Embedding(10, 5, padding_idx=0))
    check(lambda: jl(J.to_tensor(ids)), lambda: tl(T.to_tensor(ids)))
    for p in (J, T):
        d = p.nn.Dropout(0.5)
        d.eval()
        np.testing.assert_array_equal(to_numpy(d(p.to_tensor(VEC))), VEC)
    T.seed(1)
    kept = to_numpy(T.nn.Dropout(0.25)(T.ones([20000]))) != 0
    assert abs(kept.mean() - 0.75) < 5 * np.sqrt(0.25 * 0.75 / 20000)
    for mode in ("constant", "reflect", "replicate"):
        check(lambda v, m=mode: J.nn.Pad2D([1, 2, 0, 1], mode=m)(v),
              lambda v, m=mode: T.nn.Pad2D([1, 2, 0, 1], mode=m)(v), IMG)
    for p in (J, T):
        ll = p.nn.LayerList([p.nn.Linear(2, 2) for _ in range(3)])
        ll.append(p.nn.ReLU())
        assert len(ll) == 4 and len(ll.parameters()) == 6
        pl = p.nn.ParameterList([p.nn.Linear(2, 2).weight])
        assert len(pl.parameters()) == 1
        s = p.nn.Sequential([("a", p.nn.Linear(2, 3)), ("b", p.nn.Tanh())])
        assert list(s.state_dict()) == ["a.weight", "a.bias"]


def test_losses():
    logits = rs.randn(5, 4).astype("f4")
    label = rs.randint(0, 4, (5, 1)).astype("int64")
    soft = np.abs(rs.randn(5, 4)).astype("f4")
    soft /= soft.sum(1, keepdims=True)
    cw = np.abs(rs.randn(4)).astype("f4") + 0.1
    for kw in ({}, {"reduction": "sum"}, {"reduction": "none"},
               {"ignore_index": 2}):
        check(lambda a, kw=kw: J.nn.CrossEntropyLoss(**kw)(a, J.to_tensor(label)),
              lambda a, kw=kw: T.nn.CrossEntropyLoss(**kw)(a, T.to_tensor(label)),
              logits)
    check(lambda a, b: J.nn.functional.cross_entropy(a, b, soft_label=True),
          lambda a, b: T.nn.functional.cross_entropy(a, b, soft_label=True),
          logits, soft)
    check(lambda a: J.nn.CrossEntropyLoss(weight=J.to_tensor(cw))(
        a, J.to_tensor(label)),
        lambda a: T.nn.CrossEntropyLoss(weight=T.to_tensor(cw))(
            a, T.to_tensor(label)), logits)
    y = rs.randn(5, 4).astype("f4")
    for n in ("MSELoss", "L1Loss", "SmoothL1Loss"):
        check(lambda a, b, n=n: getattr(J.nn, n)()(a, b),
              lambda a, b, n=n: getattr(T.nn, n)()(a, b), logits, y)
    prob = (rs.rand(5, 4) > 0.5).astype("f4")
    check(lambda a: J.nn.BCEWithLogitsLoss()(a, J.to_tensor(prob)),
          lambda a: T.nn.BCEWithLogitsLoss()(a, T.to_tensor(prob)), logits)
    check(lambda a: J.nn.BCEWithLogitsLoss(pos_weight=J.to_tensor(cw))(
        a, J.to_tensor(prob)),
        lambda a: T.nn.BCEWithLogitsLoss(pos_weight=T.to_tensor(cw))(
            a, T.to_tensor(prob)), logits)
    check(lambda a: J.nn.NLLLoss()(J.nn.functional.log_softmax(a),
                                   J.to_tensor(label)),
          lambda a: T.nn.NLLLoss()(T.nn.functional.log_softmax(a),
                                   T.to_tensor(label)), logits)
    check(lambda a: J.nn.KLDivLoss()(J.nn.functional.log_softmax(a),
                                     J.to_tensor(soft)),
          lambda a: T.nn.KLDivLoss()(T.nn.functional.log_softmax(a),
                                     T.to_tensor(soft)), logits)


def test_functional_misc():
    lbl = rs.randint(0, 4, (5,)).astype("int64")
    check(lambda a: J.nn.functional.one_hot(a, 4),
          lambda a: T.nn.functional.one_hot(a, 4), lbl)
    check(lambda a: J.nn.functional.normalize(a, axis=1),
          lambda a: T.nn.functional.normalize(a, axis=1), VEC)
    check(lambda a: J.nn.functional.label_smooth(a),
          lambda a: T.nn.functional.label_smooth(a),
          np.eye(4, dtype="f4")[lbl])
    check(lambda a: J.nn.functional.unfold(a, 3, paddings=1),
          lambda a: T.nn.functional.unfold(a, 3, paddings=1), IMG)
    check(lambda a: J.nn.functional.sequence_mask(a, 5),
          lambda a: T.nn.functional.sequence_mask(a, 5),
          np.array([1, 3, 5], "int64"))
    check(lambda a: J.nn.functional.interpolate(a, scale_factor=2,
                                                 mode="bilinear"),
          lambda a: T.nn.functional.interpolate(a, scale_factor=2,
                                                 mode="bilinear"), IMG)
    check(lambda a, b: J.nn.CosineSimilarity()(a, b),
          lambda a, b: T.nn.CosineSimilarity()(a, b), VEC, VEC[::-1].copy())


def test_unported_lowerings_raise_the_later_slice_error():
    """What the port still lacks raises the later-slice error: the
    row-sharded (distributed) embedding, and an op with no lowering run
    eagerly.  The one-process sparse embedding, which raised it until
    its dense fallback came, runs as the JAX package's does (zero rows
    for the padding id).  (Conv2DTranspose, GroupNorm and InstanceNorm2D,
    which raised it until their lowerings came, are held to the JAX
    package in test_torch_nn_extras.py.)"""
    from paddle_tpu_torch.dygraph.eager import run_op

    ids_np = np.array([[1, 2, 0]], "int64")
    T.seed(0)
    emb = T.nn.Embedding(4, 3, sparse=True, padding_idx=0)
    J.seed(0)
    jemb = J.nn.Embedding(4, 3, sparse=True, padding_idx=0)
    w = np.asarray(jemb.weight.numpy())
    T.dygraph.state_dict_from_numpy(emb, {"weight": w})
    got = emb(T.to_tensor(ids_np)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jemb(J.to_tensor(ids_np)).numpy()))
    assert not got[0, 2].any()
    x = T.to_tensor(IMG)
    ids = T.to_tensor(ids_np)
    for make in (lambda: run_op("lookup_table_v2",
                                {"Ids": ids, "W": emb.weight},
                                {"__emb_row_sharded__": 2},
                                out_slots=("Out",)),
                 lambda: run_op("op_without_a_lowering", {"X": x}, {},
                                out_slots=("Out",))):
        with pytest.raises(NotImplementedError, match="later slice"):
            make()


def test_auto_cast_policy_matches_jax():
    def run(p):
        p.seed(0)
        conv, bn = p.nn.Conv2D(3, 4, 3), p.nn.BatchNorm2D(4)
        fc = p.nn.Linear(4, 3)
        return conv, bn, fc

    (jc, jb, jf), (tc, tb, tf) = run(J), run(T)
    for a, b in ((jc, tc), (jb, tb), (jf, tf)):
        T.dygraph.state_dict_from_numpy(
            b, {k: np.asarray(v.numpy()) for k, v in a.state_dict().items()})
    label = rs.randint(0, 3, (2, 1)).astype("int64")

    def fwd(p, conv, bn, fc):
        with p.amp.auto_cast(dtype="bfloat16"):
            y = conv(p.to_tensor(IMG))             # white: bf16
            z = p.nn.functional.relu(bn(y))        # gray: follows
            h = p.mean(z, axis=[2, 3])             # reduce_mean: black
            s = z + p.to_tensor(np.float32(1.0))   # gray-follow cast
            logits = fc(h)                         # white
            loss = p.nn.functional.cross_entropy(logits, p.to_tensor(label))
        loss.backward()
        return [y, z, h, s, logits, loss]

    jo, to = fwd(J, jc, jb, jf), fwd(T, tc, tb, tf)
    for a, b in zip(jo, to):
        assert str(a.dtype).split(".")[-1] == str(b.dtype).split(".")[-1]
        assert_close(to_numpy(a).astype("f4"), to_numpy(b).astype("f4"),
                     BF16_TOL)
    for a, b in ((jc.weight, tc.weight), (jf.weight, tf.weight)):
        assert b.grad.dtype == torch.float32
        assert_close(to_numpy(a.grad), to_numpy(b.grad), 2.0 ** -4)


def test_layer_api_matches_jax():
    """Registration, traversal, train/eval, state dicts and forward hooks
    behave as the JAX package's ``Layer`` does."""
    def run(p):
        class Net(p.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = p.nn.Linear(6, 3)
                self.bn = p.nn.BatchNorm1D(3)
                self.scale = self.create_parameter(
                    [3], default_initializer=p.nn.initializer.Constant(2.0))
                self.register_buffer("steps", p.to_tensor(
                    np.zeros([1], "f4")))

            def forward(self, x):
                return self.bn(self.fc(x)) * self.scale

        net = Net()
        seen = []
        pre = net.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2.0,))
        post = net.register_forward_post_hook(
            lambda layer, inputs, out: seen.append(out.shape) or out + 1.0)
        net.eval()
        modes = [l.training for l in net.sublayers()]
        net.train()
        out = to_numpy(net(p.to_tensor(VEC)))
        pre.remove(), post.remove()
        return dict(names=[n for n, _ in net.named_parameters()],
                    buffers=[n for n, _ in net.named_buffers()],
                    sub=[n for n, _ in net.named_sublayers()],
                    keys=list(net.state_dict()), modes=modes, seen=seen,
                    missing=net.set_state_dict({"scale": np.ones(3, "f4"),
                                                "nope": 1}),
                    scale=to_numpy(net.scale), n=len(net.parameters()),
                    shape=out.shape)

    a, b = run(J), run(T)
    for k in a:
        if k not in ("missing",):
            assert a[k] == b[k] if not isinstance(a[k], np.ndarray) \
                else np.array_equal(a[k], b[k]), k
    assert (sorted(a["missing"][0]), a["missing"][1]) == \
        (sorted(b["missing"][0]), b["missing"][1])


def test_initializer_statistics():
    """Each initializer's eager draw on the place: shapes, dtypes and
    statistics (means and standard deviations within 5 standard errors
    of the distribution's; the JAX package draws other numbers)."""
    T.seed(11)
    init = T.nn.initializer
    n_in, n_out = 400, 300
    cases = [(init.Constant(0.5), 0.5, 0.0),
             (init.Uniform(-0.2, 0.6), 0.2, 0.8 / np.sqrt(12)),
             (init.Normal(0.1, 0.3), 0.1, 0.3),
             (init.TruncatedNormal(0.0, 1.0), 0.0, 0.8796),
             (init.XavierUniform(), 0.0, np.sqrt(2.0 / (n_in + n_out))),
             (init.XavierNormal(), 0.0, np.sqrt(2.0 / (n_in + n_out))),
             (init.KaimingNormal(), 0.0, np.sqrt(2.0 / n_in)),
             (init.KaimingUniform(), 0.0, np.sqrt(2.0 / n_in))]
    for ini, mean, std in cases:
        p = T.nn.Linear(n_in, n_out,
                        weight_attr=T.ParamAttr(initializer=ini)).weight
        assert p.dtype == torch.float32 and p._value.is_leaf
        w = to_numpy(p).astype(np.float64)
        assert w.shape == (n_in, n_out)
        se = max(std, 1e-12) / np.sqrt(w.size)
        assert abs(w.mean() - mean) < 5 * se + 1e-7, type(ini).__name__
        assert abs(w.std() - std) < 5 * std / np.sqrt(2 * w.size) + 1e-7, \
            type(ini).__name__
    a = np.arange(6, dtype="f4").reshape(2, 3)
    w = T.nn.Linear(2, 3, weight_attr=T.ParamAttr(
        initializer=init.Assign(a))).weight
    np.testing.assert_array_equal(to_numpy(w), a)
    assert np.abs(to_numpy(T.nn.Linear(2, 3).bias)).max() == 0.0


# batch_norm_training's cases of test_torch_conv_ops.py: (shape, layout,
# scale and shift of the standard normal input)
BN_TRAIN_CASES = [((2, 4, 9, 10), "NCHW", 2.0, 1.0),
                  ((8, 3), "NCHW", 1.0, 0.0),
                  ((2, 9, 10, 4), "NHWC", 3.0, -2.0)]


@pytest.mark.parametrize("dtype,rtol", [("f4", 1e-5), ("f8", 1e-12)])
@pytest.mark.parametrize("shape,layout,mul,add", BN_TRAIN_CASES)
def test_eager_batch_norm_backward_against_autograd(shape, layout, mul, add,
                                                    dtype, rtol, monkeypatch):
    """Batch norm under batch statistics, two ways, each against autograd
    through a float64 two-pass batch norm on the same inputs: the eager
    rule's ``_BatchNormTrain`` (its backward the closed form of the static
    ``batch_norm_grad``) and autograd through the static lowering's
    one-pass moments (``_bn_batch_stats``).  Y and the gradients of X,
    Scale and Bias in the inputs' dtype, within ``rtol`` of the float64
    result's largest magnitude: float32 inputs accumulate in float32
    (1e-5), float64 inputs in float64 (1e-12).  Through ``run_op``,
    dygraph records ``_BatchNormTrain``; the registered lowering records
    plain autograd nodes."""
    from paddle_tpu_torch.dygraph import eager
    from paddle_tpu_torch.ops import nn_ops

    g = np.random.RandomState(11)
    caxis = 1 if layout == "NCHW" else len(shape) - 1
    c = shape[caxis]
    x = torch.tensor((g.randn(*shape) * mul + add).astype(dtype))
    scale, bias = (torch.tensor(g.randn(c).astype(dtype)) for _ in range(2))
    dy = torch.tensor(g.randn(*shape).astype(dtype))
    red = tuple(i for i in range(len(shape)) if i != caxis)
    bshape = [1] * len(shape)
    bshape[caxis] = c

    def grads(fn, *ins):
        ins = [t.detach().clone().requires_grad_(True) for t in ins]
        y = fn(*ins)
        return [y] + list(torch.autograd.grad(y, ins, dy.to(y.dtype)))

    def two_pass(x, s, b):
        m = x.mean(dim=red, keepdim=True)
        v = ((x - m) ** 2).mean(dim=red, keepdim=True)
        return (x - m) / torch.sqrt(v + 1e-5) * s.reshape(bshape) \
            + b.reshape(bshape)

    want = grads(two_pass, x.double(), scale.double(), bias.double())
    for name, fn in (("eager", nn_ops._BatchNormTrain.apply),
                     ("lowering", nn_ops._bn_batch_stats)):
        got = grads(lambda *a: fn(*a, 1e-5, red, bshape)[0], x, scale, bias)
        for slot, a, b in zip(("Y", "X@GRAD", "Scale@GRAD", "Bias@GRAD"),
                              got, want):
            assert a.dtype == x.dtype
            assert_close(b.detach().numpy(), a.detach().numpy(), rtol,
                         f"{name} {slot}")

    def run(rules):
        monkeypatch.setattr(eager, "_EAGER_RULES", rules)
        ins = dict(X=x.clone().requires_grad_(True), Scale=scale, Bias=bias,
                   Mean=torch.zeros(c, dtype=x.dtype),
                   Variance=torch.ones(c, dtype=x.dtype))
        out = eager.run_op("batch_norm", ins, dict(data_layout=layout))
        return type(out["Y"]._value.grad_fn).__name__

    assert run(eager._EAGER_RULES) == "_BatchNormTrainBackward"
    assert "BatchNormTrain" not in run({})
