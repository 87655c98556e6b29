"""PyTorch port: trace-based jit (``TracedLayer``, ``to_static``,
``jit.save`` / ``jit.load``, ``Model.save(training=False)``,
``flops`` / ``summary`` of a Layer) against the JAX package (its
``tests/test_jit.py``), on the CPU.

- Layers are built in both packages and the JAX one's state dict is
  carried into the port's (``torch_dygraph_parity.pair``).
- Traced and loaded outputs are held to the same package's eager
  forward within 1e-5 relative (the executor runs the same lowerings
  op by op; 1e-4 where the JAX test holds a reloaded program to it, a
  Predictor compiling its own program), and the port's to the JAX
  package's within ``torch_dygraph_parity.RTOL`` (float32 convolutions
  and matmuls in other summation orders).
- The port's own semantics: the Python body runs once; parameters are
  snapshots taken at trace time; a trace's key carries the device; a
  traced dygraph encoder records the JAX package's op types; a model
  saved by the JAX package's ``jit.save`` serves in the port.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.dygraph.jit as jjit
import paddle_tpu_torch as T
import paddle_tpu_torch.dygraph.jit as tjit
from torch_dygraph_parity import (  # noqa: F401
    RTOL,
    _jax_eager_keys_kept,
    assert_close,
    pair,
)

JIT = {J: jjit, T: tjit}


def _lenet(P):
    nn = P.nn

    class LeNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2D(1, 6, 5, padding=2)
            self.p1 = nn.MaxPool2D(2, 2)
            self.c2 = nn.Conv2D(6, 16, 5)
            self.p2 = nn.MaxPool2D(2, 2)
            self.fc1 = nn.Linear(16 * 5 * 5, 64)
            self.fc2 = nn.Linear(64, 10)

        def forward(self, x):
            y = self.p1(nn.functional.relu(self.c1(x)))
            y = self.p2(nn.functional.relu(self.c2(y)))
            # 0 copies the input's dim: the trace stays batch-agnostic
            y = P.reshape(y, [0, -1])
            y = nn.functional.relu(self.fc1(y))
            return self.fc2(y)

    net = LeNet()
    net.eval()
    return net


def _x(seed, batch=4):
    return np.random.RandomState(seed).randn(batch, 1, 28, 28).astype("f4")


def _tensor(P, a):
    return P.dygraph.to_variable(np.array(a))


def _out(o):
    o = o[0] if isinstance(o, (list, tuple)) else o
    return np.asarray(o.numpy())


def test_traced_layer_matches_eager_and_roundtrips(tmp_path):
    nets = dict(zip((J, T), pair(_lenet)))
    got = {}
    for P, net in nets.items():
        with P.dygraph.guard():
            x = _tensor(P, _x(0))
            eager = _out(net(x))
            outs, traced = JIT[P].TracedLayer.trace(net, [x])
            np.testing.assert_allclose(_out(outs), eager, rtol=1e-5)
            x2 = _tensor(P, _x(1))
            want = _out(net(x2))
            np.testing.assert_allclose(_out(traced(x2)), want, rtol=1e-4,
                                       atol=1e-5)
            model_dir = str(tmp_path / f"lenet_{P.__name__}")
            traced.save_inference_model(model_dir)
            loaded = JIT[P].load(model_dir)
            got[P] = _out(loaded(x2))
            np.testing.assert_allclose(got[P], want, rtol=1e-4, atol=1e-5)
            assert [op.type for op in traced.program.global_block.ops] == \
                ["conv2d", "elementwise_add", "relu", "pool2d", "conv2d",
                 "elementwise_add", "relu", "pool2d", "reshape2",
                 "matmul_v2", "elementwise_add", "relu", "matmul_v2",
                 "elementwise_add"]
    assert_close(got[J], got[T])


def test_jit_save_with_input_spec_and_load(tmp_path):
    nets = dict(zip((J, T), pair(_lenet)))
    got = {}
    for P, net in nets.items():
        model_dir = str(tmp_path / f"lenet_spec_{P.__name__}")
        with P.dygraph.guard():
            JIT[P].save(net, model_dir,
                        input_spec=[P.hapi.model.InputSpec([-1, 1, 28, 28])])
            loaded = JIT[P].load(model_dir)
            # traced at batch 1, served at batch 2
            x = _tensor(P, _x(1, batch=2))
            want = _out(net(x))
            got[P] = _out(loaded(x))
            np.testing.assert_allclose(got[P], want, rtol=1e-4, atol=1e-5)
    assert_close(got[J], got[T])


@pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])
def test_to_static_compiles_and_matches(P):
    calls = []

    @JIT[P].to_static
    def f(a, b):
        calls.append(1)
        return P.matmul(a, b) + a

    rng = np.random.RandomState(0)
    a_np, b_np = rng.randn(3, 3).astype("f4"), rng.randn(3, 3).astype("f4")
    with P.dygraph.guard():
        a, b = _tensor(P, a_np), _tensor(P, b_np)
        want = a_np @ b_np + a_np
        np.testing.assert_allclose(_out(f(a, b)), want, rtol=1e-5)
        np.testing.assert_allclose(_out(f(a, b)), want, rtol=1e-5)
    assert len(calls) == 1, "the Python body runs only for the trace"


def test_model_save_inference_export(tmp_path):
    nets = dict(zip((J, T), pair(_lenet)))
    got = {}
    for P, net in nets.items():
        model = P.Model(net, inputs=[P.hapi.model.InputSpec([-1, 1, 28, 28])])
        path = str(tmp_path / f"hapi_export_{P.__name__}")
        model.save(path, training=False)
        with P.dygraph.guard():
            loaded = JIT[P].load(path)
            x = _tensor(P, _x(2, batch=2))
            net.eval()
            want = _out(net(x))
            got[P] = _out(loaded(x))
            np.testing.assert_allclose(got[P], want, rtol=1e-4, atol=1e-5)
    assert_close(got[J], got[T])


def test_parameters_are_snapshots_at_trace_time():
    """A later change to the dygraph parameter does not reach the traced
    program, as the JAX package copies it to the host at the trace."""
    net = _lenet(T)
    x = _tensor(T, _x(3))
    _, traced = tjit.TracedLayer.trace(net, [x])
    before = _out(traced(x))
    with torch.no_grad():
        net.fc2.bias._value.add_(1.0)
    np.testing.assert_allclose(_out(traced(x)), before, rtol=0)
    np.testing.assert_allclose(_out(net(x)), before + 1.0, rtol=1e-5)
    # the snapshot is a clone on the parameter's own device
    snap = traced._param_values[net.fc2.bias.name]
    assert snap.device == net.fc2.bias._value.device
    assert snap.data_ptr() != net.fc2.bias._value.data_ptr()


def test_static_function_key_carries_the_device():
    """A trace made on one device is never replayed on another's inputs:
    the key holds the device beside the shape and dtype."""
    from paddle_tpu_torch.dygraph.tensor import _wrap

    sf = tjit.to_static(lambda x: x * 2.0)
    cpu = _wrap(torch.zeros(2, 3))
    meta = _wrap(torch.zeros(2, 3, device="meta"))
    assert sf._key([cpu]) != sf._key([meta])
    assert sf._key([cpu]) == ((( 2, 3), torch.float32,
                               torch.device("cpu")),)
    np.testing.assert_allclose(_out(sf(_tensor(T, np.ones((2, 3), "f4")))),
                               np.full((2, 3), 2.0))
    # the executor runs where the traced state lives
    assert sf.concrete_program._exe.device == torch.device("cpu")


def _encoder(P):
    nn = P.nn
    layer = nn.TransformerEncoderLayer(32, 4, 64, dropout=0.0)
    enc = nn.TransformerEncoder(layer, 2)
    enc.eval()
    return enc


def test_dygraph_encoder_traces_the_jax_op_types():
    """A 2-layer dygraph encoder records the JAX package's op types, in
    its order, and its traced forward matches the JAX one's."""
    encs = dict(zip((J, T), pair(_encoder)))
    src = np.random.RandomState(4).randn(2, 8, 32).astype("f4")
    got, types = {}, {}
    for P, enc in encs.items():
        with P.dygraph.guard():
            x = _tensor(P, src)
            eager = _out(enc(x))
            _, traced = JIT[P].TracedLayer.trace(enc, [x])
            got[P] = _out(traced(x))
            np.testing.assert_allclose(got[P], eager, rtol=1e-5, atol=1e-6)
            types[P] = [op.type for op in traced.program.global_block.ops]
    assert types[T] == types[J]
    assert types[T].count("matmul_v2") == 2 * (4 + 2 + 2)
    assert_close(got[J], got[T])


def test_flops_and_summary_of_a_layer_match_jax(monkeypatch):
    """The port's trace for pricing keeps no copy of the parameters."""
    recs = []
    real = tjit._ProgramRecorder
    monkeypatch.setattr(tjit, "_ProgramRecorder",
                        lambda *a: recs.append(real(*a)) or recs[-1])
    nets = dict(zip((J, T), pair(_lenet)))
    flops = {P: P.flops(net, [1, 1, 28, 28]) for P, net in nets.items()}
    summ = {P: P.summary(net, (1, 1, 28, 28)) for P, net in nets.items()}
    assert flops[T] == flops[J] > 0
    assert summ[T] == summ[J]
    assert summ[T]["flops"] == flops[T]
    assert len(recs) == 2 and not any(r.param_values for r in recs)


def test_model_saved_by_the_jax_package_serves_in_the_port(tmp_path):
    """jit.save in the JAX package, jit.load in the port: the same
    outputs (the codec and the parameter files are shared)."""
    jnet = _lenet(J)
    path = str(tmp_path / "jax_saved")
    with J.dygraph.guard():
        jjit.save(jnet, path, input_spec=[J.hapi.model.InputSpec(
            [-1, 1, 28, 28])])
        want = _out(jjit.load(path)(_tensor(J, _x(5, batch=3))))
    got = _out(tjit.load(path)(_tensor(T, _x(5, batch=3))))
    assert_close(want, got)


def test_trace_op_hands_off_to_the_callers_tensor():
    """``Tracer.trace_op`` writes an op's result into the caller's own
    output tensor, and a trace follows that tensor."""
    from paddle_tpu_torch.dygraph.eager import tracer
    from paddle_tpu_torch.dygraph.tensor import Tensor

    def f(x):
        out = Tensor(np.zeros((2,), "f4"))
        tracer().trace_op("scale", {"X": x}, {"Out": out},
                          {"scale": 3.0, "bias": 0.0})
        return out * 2.0

    x = _tensor(T, np.ones((2,), "f4"))
    np.testing.assert_allclose(_out(f(x)), [6.0, 6.0])
    _, traced = tjit.TracedLayer.trace(f, [x])
    assert [op.type for op in traced.program.global_block.ops] == \
        ["scale", "elementwise_mul"]
    np.testing.assert_allclose(
        _out(traced(_tensor(T, np.full((2,), 2.0, "f4")))), [12.0, 12.0])
