"""PyTorch port: dy2static's branches and returns against the JAX
package (its ``tests/test_dy2static.py``, the cases without a loop
here, the loops in ``test_torch_dy2static_loops.py``).

- Each case's function is written once against either package
  (``torch_dy2static_cases``); both trace it on one input, and the
  port's converted program has the JAX program's op types, block by
  block.  Both programs reproduce eager dygraph on every input, which
  takes each branch: the values are float32 sums and products of powers
  of two, exact in both packages (``rtol`` 0).
- ``jit.save`` -> ``jit.load`` of a branch and a loop reproduces eager
  within 1e-6 relative, as the JAX test holds it; ``use_prune`` keeps
  the producers of a branch's pass-through output; the shims route
  static ``Variable``s to ``layers.cond``.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_dy2static_run import JIT, run_case
from torch_dygraph_parity import _jax_eager_keys_kept  # noqa: F401

CASES = ["if_both_branches", "if_return_form", "bool_ops_and_not",
         "nested_if_converts", "early_return_tensor_cond_converts",
         "python_guard_early_return_still_traces",
         "layer_forward_hooks_survive_conversion"]


@pytest.mark.parametrize("name", CASES)
def test_case_matches_jax_and_eager(name):
    types = run_case(name)
    if name in ("if_both_branches", "nested_if_converts"):
        assert "cond_pair" in types[0]


@pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])
def test_jit_save_load_predictor_roundtrip(P, tmp_path):
    """The VERDICT criterion: a data-dependent branch and loop export
    through jit.save; the loaded model reproduces eager on both branches
    and at 0, 1 and several trips."""
    jit = JIT[P]

    def model(x):
        if x.mean() > 0:
            h = x * 2.0
        else:
            h = x * -3.0
        s = h
        while s.sum() < 64.0:
            s = s * 2.0
        return s

    static = jit.to_static(model)
    path = str(tmp_path / "dy2static_model")
    with P.dygraph.guard():
        jit.save(static, path,
                 input_spec=[P.dygraph.to_variable(np.full((2, 2), 0.5,
                                                           "f4"))])
        loaded = jit.load(path)
        for fill in (0.5, -0.25, 5.0, 20.0):
            x = np.full((2, 2), fill, "f4")
            want = static._fn(P.dygraph.to_variable(x)).numpy()
            got = loaded(P.dygraph.to_variable(x))
            got = got[0] if isinstance(got, list) else got
            np.testing.assert_allclose(np.asarray(got.numpy()), want,
                                       rtol=1e-6)


def test_use_prune_keeps_cond_passthrough_producers():
    """Executor.run(use_prune=True) keeps the ops producing a branch's
    pass-through output, in both packages."""
    def f(x):
        y1 = x * 2.0
        y2 = x * 3.0
        if x.mean() > 0:
            z = y1
        else:
            z = y2
        return z

    for P in (J, T):
        with P.dygraph.guard():
            xv = np.full((2,), 1.0, "f4")
            _, tl = JIT[P].TracedLayer.trace(f, [P.dygraph.to_variable(xv)])
            exe, scope = tl._ensure_exe()
            for v, want in ((xv, 2.0), (-xv, -3.0)):
                out = exe.run(tl.program, feed={tl._feed_names[0]: v},
                              fetch_list=tl._fetch_names, scope=scope,
                              use_prune=True)
                np.testing.assert_allclose(np.asarray(out[0]), [want] * 2)


@pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])
def test_static_mode_variable_dispatch(P):
    """The convert shims route framework Variables to layers.cond."""
    from importlib import import_module

    convert_ifelse = import_module(
        P.__name__ + ".dygraph.dy2static").convert_ifelse
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        x = P.layers.data("x", [3])
        pred = P.layers.reduce_sum(x) > 0.0
        out = convert_ifelse(pred, lambda: x * 2.0, lambda: x - 1.0, (), {})
    exe = P.Executor(P.CPUPlace())
    o1 = exe.run(main, feed={"x": np.ones((1, 3), "f4")}, fetch_list=[out])
    o2 = exe.run(main, feed={"x": -np.ones((1, 3), "f4")}, fetch_list=[out])
    np.testing.assert_allclose(np.asarray(o1[0]), np.full((1, 3), 2.0))
    np.testing.assert_allclose(np.asarray(o2[0]), np.full((1, 3), -2.0))


def _flat_if(x):
    if x.mean() > 0:
        y = x * 2.0 + 1.0
    else:
        y = -x
    return y


def _nested_if(x):
    if x.mean() > 0:
        if x.sum() > 10.0:
            y = x * 2.0
        else:
            y = x * 3.0
    else:
        y = -x
    return y


@pytest.mark.parametrize("fn,fills,want", [
    (_flat_if, (1.0, -1.0), (3.0, 1.0)),
    (_nested_if, (-1.0, 1.0, 0.5), (1.0, 2.0, 1.5))],
    ids=["flat", "nested"])
def test_traced_branch_runs_at_another_batch(monkeypatch, fn, fills, want):
    """A program traced at one batch runs at another: the branch that
    does not run is shaped over meta tensors at the run's shapes, not by
    the trace's declared ones, which stand in only at the traced
    shapes.  A nested ``if`` in that branch is shaped by both its
    branches over meta (a fill of -1 leaves the outer true branch, which
    holds it, untaken)."""
    from paddle_tpu_torch.ops import control_flow

    probes = []
    real = control_flow._to_meta
    monkeypatch.setattr(control_flow, "_to_meta",
                        lambda v: probes.append(1) or real(v))
    got = {}
    for P in (J, T):
        with P.dygraph.guard():
            _, tl = JIT[P].TracedLayer.trace(
                fn, [P.dygraph.to_variable(np.ones((2, 3), "f4"))])
            got[P] = [np.asarray(tl(P.dygraph.to_variable(
                np.full((5, 3), v, "f4")))[0].numpy()) for v in fills]
    for j, t, w in zip(got[J], got[T], want):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, np.full((5, 3), w))
    assert probes
    probes.clear()
    with T.dygraph.guard():
        out = tl(T.dygraph.to_variable(np.full((2, 3), -1.0, "f4")))[0]
    np.testing.assert_array_equal(out.numpy(), np.ones((2, 3)))
    assert not probes, "at the traced shapes the declared ones serve"


@pytest.mark.parametrize("P", [J, T], ids=["jax", "torch"])
def test_untaken_branch_error_at_another_batch_is_loud(P):
    """A branch that cannot lower at the run's shapes raises, also when
    it does not run: its reshape baked the traced batch in.  The port's
    meta probe names the op rather than a branch mismatch."""
    def f(x):
        if x.mean() > 0:
            y = x * 2.0
        else:
            y = P.reshape(P.reshape(x, [6]), [2, 3])
        return y

    with P.dygraph.guard():
        _, tl = JIT[P].TracedLayer.trace(
            f, [P.dygraph.to_variable(np.ones((2, 3), "f4"))])
        with pytest.raises(Exception) as err:
            tl(P.dygraph.to_variable(np.ones((5, 3), "f4")))
    if P is T:
        assert "reshape2" in str(err.value)
        assert "disagree" not in str(err.value)
