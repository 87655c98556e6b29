"""Shared harness of the dygraph parity tests (``test_torch_tensor_*``,
``test_torch_dygraph*``): the same numpy inputs, made from a seed, go
through a function of the JAX package's 2.0 API and its counterpart in
the port (``paddle_tpu_torch``, on the CPU), and the outputs and the
inputs' gradients are compared.

``check`` compares, for each output: booleans and integers exactly (by
value: the port keeps 64-bit integers where the JAX package, x64 off,
computes in 32 bits), floats within ``rtol`` of the JAX result's largest
magnitude.  Gradients: both sides back-propagate ``sum(out * w)`` over
their floating outputs, ``w`` one seeded weight per output, and each
floating input's gradient is compared the same way (a gradient neither
side reaches is zero on both).
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T

T.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _jax_eager_keys_kept():
    """The JAX package's eager key stream, and both packages' default
    programs' seeds, as they were before the module: these tests draw
    from the stream and call ``seed``, and a test that later runs in the
    same worker must see what it would see without them.  Each module
    imports this fixture."""
    from paddle_tpu.dygraph import base
    from paddle_tpu_torch.framework import program as tprogram

    saved = base._state._rng_key
    progs = (tprogram.default_main_program(),
             tprogram.default_startup_program())
    seeds = [p.random_seed for p in progs]
    yield
    base._state._rng_key = saved
    for p, seed in zip(progs, seeds):
        p.random_seed = seed

# float32 on both sides, in other summation orders: values of order 1
# agree to a few ulp; 1e-5 of the largest magnitude leaves room for the
# longer reductions (a product, a logsumexp) and stays far below any
# wrong formula's error.
RTOL = 1e-5


def tensors(pkg, arrays, grad):
    out = []
    for a in arrays:
        if isinstance(a, np.ndarray):
            out.append(pkg.to_tensor(a, stop_gradient=not (
                grad and a.dtype.kind == "f")))
        elif isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
            out.append(tensors(pkg, a, grad))
        else:
            out.append(a)
    return out


def flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat(o)]
    return [out]


def to_numpy(t):
    if hasattr(t, "numpy"):
        return np.asarray(t.numpy())
    return np.asarray(t)


def assert_close(want, got, rtol=RTOL, what=""):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.astype(np.float64), err_msg=what)
        return
    want, got = want.astype(np.float64), got.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    if fin.any():
        scale = max(np.abs(want[fin]).max(), 1e-30)
        err = np.abs(got[fin] - want[fin]).max()
        assert err <= rtol * scale, (what, err, scale)


def _float_inputs(xs):
    return [x for x in flat(xs) if hasattr(x, "stop_gradient")
            and not x.stop_gradient]


def check(jfn, tfn, *arrays, grad=True, rtol=RTOL, seed=0, **kwargs):
    """Run ``jfn``/``tfn`` on ``arrays`` (numpy arrays become tensors;
    other values pass as they are) and compare outputs and gradients."""
    jx, tx = tensors(J, arrays, grad), tensors(T, arrays, grad)
    jo, to = flat(jfn(*jx, **kwargs)), flat(tfn(*tx, **kwargs))
    assert len(jo) == len(to)
    for i, (a, b) in enumerate(zip(jo, to)):
        assert_close(to_numpy(a), to_numpy(b), rtol, f"output {i}")
    jin, tin = _float_inputs(jx), _float_inputs(tx)
    if not jin:
        return jo, to
    rs = np.random.RandomState(seed + 1)
    jl = tl = None
    for a, b in zip(jo, to):
        if b.stop_gradient or not np.issubdtype(to_numpy(a).dtype,
                                                np.floating):
            continue
        w = np.asarray(rs.randn(*to_numpy(a).shape), "float32")
        ja = (a * J.to_tensor(w)).sum()
        tb = (b * T.to_tensor(w)).sum()
        jl = ja if jl is None else jl + ja
        tl = tb if tl is None else tl + tb
    if tl is None:
        return jo, to
    jl.backward()
    tl.backward()
    for i, (a, b) in enumerate(zip(jin, tin)):
        ga = np.zeros(a.shape, "float32") if a.grad is None \
            else to_numpy(a.grad)
        gb = np.zeros(b.shape, "float32") if b.grad is None \
            else to_numpy(b.grad)
        assert_close(ga, gb, rtol, f"gradient of input {i}")
    return jo, to


def same(name, *arrays, module="", **kwargs):
    """``check`` of the function called ``name`` in both packages
    (``module`` a dotted path under each package, e.g. "nn.functional")."""
    def get(pkg):
        obj = pkg
        for part in filter(None, module.split(".")):
            obj = getattr(obj, part)
        return getattr(obj, name)

    opts = {k: kwargs.pop(k) for k in ("grad", "rtol", "seed")
            if k in kwargs}
    return check(lambda *a: get(J)(*a, **kwargs),
                 lambda *a: get(T)(*a, **kwargs), *arrays, **opts)


def pair(make):
    """``make(J)`` and ``make(T)`` (two layers), the JAX one's
    ``state_dict()`` carried into the port's; the key lists are equal."""
    jl, tl = make(J), make(T)
    sd = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert list(sd) == list(tl.state_dict())
    T.dygraph.state_dict_from_numpy(tl, sd)
    return jl, tl
