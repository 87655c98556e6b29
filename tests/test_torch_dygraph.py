"""PyTorch port: dygraph mode (``paddle_tpu_torch/dygraph``,
``autograd.py``) against the JAX package's dygraph, on the CPU.

Tensor semantics (``stop_gradient``, ``.grad`` accumulating until
``clear_grad``, ``detach``, ``no_grad``), ``paddle.grad`` with
``create_graph`` (double grad), ``allow_unused``, gradient hooks and
``PyLayer``, each run through both packages on the same seeded numpy
inputs; gradients within 1e-5 of the JAX result's largest magnitude
(``torch_dygraph_parity``: float32 both sides, other summation orders).
Then the port's own contracts: a parameter updated in place keeps its
identity and its address, the place (``set_device`` raises without a
card; nothing falls back), and a check that no module of the port
imports ``jax`` or ``paddle_tpu``.
"""
import ast
import importlib
import os
import pkgutil

import numpy as np
import pytest
import torch

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close)

rs = np.random.RandomState(5)
X = rs.randn(3, 4).astype("f4")
W = rs.randn(4, 2).astype("f4")


def _both(fn):
    """``fn(pkg)`` for each package -> (jax result, torch result)."""
    return fn(J), fn(T)


def _np(t):
    return None if t is None else np.asarray(t.numpy())


def test_stop_gradient_and_leaf_semantics():
    def run(p):
        x = p.to_tensor(X)
        w = p.to_tensor(W, stop_gradient=False)
        y = p.matmul(x, w)
        z = y.detach()
        return (x.stop_gradient, w.stop_gradient, y.stop_gradient,
                z.stop_gradient, (x * 2).stop_gradient)

    assert _both(run)[0] == _both(run)[1] == (True, False, False, True, True)


def test_grad_accumulates_until_clear_grad():
    def run(p):
        w = p.to_tensor(W, stop_gradient=False)
        x = p.to_tensor(X)
        grads = []
        for k in range(3):
            loss = (p.matmul(x, w) * (k + 1.0)).sum()
            loss.backward()
            grads.append(_np(w.grad))
        w.clear_grad()
        loss = p.tanh(p.matmul(x, w)).mean()
        loss.backward()
        grads.append(_np(w.grad))
        return grads

    for a, b in zip(*_both(run)):
        assert_close(a, b)


def test_no_grad_records_nothing():
    def run(p):
        w = p.to_tensor(W, stop_gradient=False)
        with p.no_grad():
            y = p.matmul(p.to_tensor(X), w)
        sg = y.stop_gradient

        @p.no_grad()
        def f(v):
            return v * 3

        return sg, f(w).stop_gradient, p.dygraph.no_grad(lambda v: v + 1)(
            w).stop_gradient

    assert _both(run) == ((True, True, True), (True, True, True))


def test_paddle_grad_create_graph_double_grad():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        y = (x * x * x).sum()
        (g,) = p.grad(y, x, create_graph=True)
        gg = (g * g).sum()
        (h,) = p.grad(gg, x)
        (g2,) = p.grad(p.sin(x).sum(), x, retain_graph=False)
        return _np(g), _np(h), _np(g2), g.stop_gradient

    (jg, jh, jg2, jsg), (tg, th, tg2, tsg) = _both(run)
    assert_close(jg, tg)
    assert_close(jh, th)
    assert_close(jg2, tg2)
    assert jsg is False and tsg is False


def test_paddle_grad_allow_unused_and_grad_outputs():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        u = p.to_tensor(W, stop_gradient=False)
        y = p.exp(x)
        seed = p.to_tensor(np.full(X.shape, 0.5, "f4"))
        gx, gu = p.grad([y], [x, u], grad_outputs=[seed], allow_unused=True)
        with pytest.raises(RuntimeError):
            p.grad([p.exp(x).sum()], [u])
        return _np(gx), gu

    (jgx, jgu), (tgx, tgu) = _both(run)
    assert_close(jgx, tgx)
    assert jgu is None and tgu is None


def test_gradient_hooks_replace_the_gradient():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        seen = []
        h = x.register_hook(lambda g: seen.append(_np(g)) or g * 2)
        y = p.tanh(x)
        y.register_hook(lambda g: g + 1.0)
        y.sum().backward()
        first = _np(x.grad)
        h.remove()
        x.clear_grad()
        p.tanh(x).sum().backward()
        with pytest.raises(RuntimeError):
            p.to_tensor(X).register_hook(lambda g: g)
        return first, seen[0], _np(x.grad)

    for a, b in zip(*_both(run)):
        assert_close(a, b)


def test_pylayer_custom_backward():
    def run(p):
        class CubeTimes(p.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k):
                ctx.save_for_backward(x)
                ctx.k = k
                return x * x * x * k, p.argmax(x, axis=1)

            @staticmethod
            def backward(ctx, dy, _didx):
                (x,) = ctx.saved_tensor()
                return dy * x * x * (3.0 * ctx.k + 1.0)   # not the true one

        x = p.to_tensor(X, stop_gradient=False)
        y, idx = CubeTimes.apply(x, 2.0)
        (y * p.to_tensor(W[:3, :1].repeat(4, 1))).sum().backward()
        return _np(y), _np(idx), _np(x.grad), y.stop_gradient

    (jy, ji, jg, jsg), (ty, ti, tg, tsg) = _both(run)
    assert_close(jy, ty)
    np.testing.assert_array_equal(ji, ti)
    assert_close(jg, tg)
    assert jsg is False and tsg is False


def test_autograd_backward_with_grad_tensors():
    def run(p):
        x = p.to_tensor(X, stop_gradient=False)
        a, b = p.exp(x), p.sin(x)
        p.autograd.backward([a, b], [p.ones_like(a), p.full_like(b, 2.0)])
        with pytest.raises(ValueError):
            p.autograd.backward([a, b], [p.ones_like(a)])
        return _np(x.grad)

    assert_close(*_both(run))


def test_parameter_update_in_place_keeps_identity_and_address():
    lin = T.nn.Linear(4, 2)
    w = lin.weight
    value, ptr = w._value, w._value.data_ptr()
    (lin(T.to_tensor(X)).sum()).backward()
    T.optimizer.SGD(0.1, parameters=lin.parameters()).step()
    assert w._value is value and w._value.data_ptr() == ptr
    assert w._value.is_leaf and w._value.requires_grad
    w.set_value(np.zeros((4, 2), "f4"))
    assert w._value is value and float(w._value.abs().sum()) == 0.0


def test_set_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert T.get_device() == "cpu"
    for place in ("gpu:0", "gpu", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            T.set_device(place)
    assert T.get_device() == "cpu"          # unchanged, no fallback
    with pytest.raises(ValueError):
        T.set_device("tpu:0")
    from paddle_tpu_torch.dygraph import base

    prev = base._state.place
    base._state.place = "gpu:0"             # the default place
    try:
        for make in (lambda: T.to_tensor(X), lambda: T.nn.Linear(2, 2),
                     lambda: T.zeros([2]), lambda: T.randn([2])):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    finally:
        base._state.place = prev


def test_tensor_api_on_graph_variables_appends_the_same_ops():
    """Given static Variables, the 2.0 functions append IR ops (the
    dispatch's static branch), the same ops in both packages, and the
    port's executor runs them to the JAX executor's results."""
    import paddle_tpu_torch.nn.functional as TF
    import paddle_tpu.nn.functional as JF

    feed = {"x": X}
    results, types = [], []
    for p, F in ((J, JF), (T, TF)):
        main, startup = p.framework.Program(), p.framework.Program()
        with p.framework.program_guard(main, startup):
            x = p.layers.data("x", [3, 4], append_batch_size=False)
            y = F.relu(p.tensor.math.scale(x, 2.0, bias=-0.5))
            z = p.tensor.reshape(p.tensor.concat([y, x], axis=1), [4, 6])
            out = p.tensor.math.mean(p.tensor.transpose(z, [1, 0]), axis=0)
        types.append([op.type for op in main.global_block.ops])
        exe = p.Executor(p.CPUPlace())
        results.append(np.asarray(exe.run(main, feed=feed,
                                          fetch_list=[out])[0]))
    assert types[0] == types[1]
    assert_close(results[0], results[1])


def _port_modules():
    import paddle_tpu_torch

    root = os.path.dirname(paddle_tpu_torch.__file__)
    for info in pkgutil.walk_packages([root], "paddle_tpu_torch."):
        yield info.name, os.path.join(root, *info.name.split(".")[1:]) + (
            "/__init__.py" if info.ispkg else ".py")


def test_no_module_of_the_port_imports_jax_or_paddle_tpu():
    """Every import statement of every port module (the ones inside
    functions too), and every module object the imported modules hold."""
    bad = []
    for name, path in _port_modules():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu", "flax"):
                    bad.append((name, m))
        mod = importlib.import_module(name)
        for v in vars(mod).values():
            top = getattr(v, "__name__", "").split(".")[0] \
                if type(v).__name__ == "module" else ""
            if top in ("jax", "jaxlib", "paddle_tpu"):
                bad.append((name, v.__name__))
    assert not bad, bad
