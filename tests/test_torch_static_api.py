"""PyTorch port: the ``static`` namespace, shape tensors, ``py_func``,
the export of a program with control flow, and the executor's reasons
to run a program eagerly, against the JAX package on the CPU.

- Every name the JAX package's ``static`` exports resolves in the
  port's; ``gradients`` gives the JAX package's values (float32,
  exact here: a square's gradient).
- ``reshape2`` with a ``ShapeTensor`` / ``Shape`` input and
  ``fill_constant`` with a ``ShapeTensor`` / ``ShapeTensorList`` take
  the JAX rule's shape (the port reads it on the host; the JAX package's
  lowerings are called on concrete arrays, as a jitted block cannot give
  them a concrete shape), so the results are equal.
- A program holding control flow, a shape tensor or a ``py_func`` runs
  eagerly, counted as ``executor_eager_<kind>``.
- ``save_inference_model`` prunes and saves a program whose branch alone
  reads a parameter; the port's and the JAX package's ``Predictor``
  serve the directory the port wrote with equal outputs (float32 fc,
  1e-6 relative).
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.framework.executor import capture_reason
from paddle_tpu_torch.monitor import stat_get
from test_torch_control_flow import _jax_eagerly

PKGS = [J, T]


def test_static_namespace_resolves_the_jax_names():
    missing = [n for n in J.static.__all__ if not hasattr(T.static, n)]
    assert missing == []
    assert T.static.Program is T.Program
    assert T.static.ParallelExecutor is T.static.CompiledProgram
    x = object()
    assert T.static.Print(x) is x


def test_gradients_name_scope_and_places():
    got = {}
    for P in PKGS:
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = P.layers.data("x", [3])
            x.stop_gradient = False
            y = P.layers.reduce_sum(P.layers.elementwise_mul(x, x))
            (dx,) = P.static.gradients([y], [x])
        exe = P.Executor(P.CPUPlace())
        got[P] = np.asarray(exe.run(
            main, feed={"x": np.array([[1.0, -2.0, 3.0]], "f4")},
            fetch_list=[dx], scope=P.framework.Scope())[0])
    np.testing.assert_array_equal(got[T], got[J])
    np.testing.assert_array_equal(got[T], [[2.0, -4.0, 6.0]])
    # name_scope prefixes names and keeps them unique on re-entry (the
    # JAX package's raises TypeError at its first name)
    with T.program_guard(T.Program(), T.Program()):
        names = []
        for _ in range(2):
            with T.static.name_scope("blk"):
                names.append(T.layers.scale(T.layers.data("z", [1]),
                                            2.0).name)
    assert names[0].startswith("blk/") and names[0] != names[1]
    assert [type(p) for p in T.static.cpu_places(2)] == [T.CPUPlace] * 2
    # cuda_places names the cards torch sees; tpu_places maps to them
    import torch

    assert len(T.static.cuda_places()) == torch.cuda.device_count()
    assert T.static.tpu_places() == [T.CUDAPlace(0)]
    assert T.static.cuda_places([1]) == [T.CUDAPlace(1)]


def test_compiled_program_runs_as_its_program():
    main, startup = T.Program(), T.Program()
    with T.program_guard(main, startup):
        x = T.layers.data("x", [2])
        y = T.layers.scale(x, 3.0)
    compiled = T.static.CompiledProgram(
        main, T.static.BuildStrategy()).with_data_parallel(
        loss_name=y.name, places=T.static.cpu_places(1))
    exe = T.Executor(T.CPUPlace())
    out = exe.run(compiled, feed={"x": np.ones((1, 2), "f4")},
                  fetch_list=[y], scope=T.framework.Scope())
    np.testing.assert_array_equal(np.asarray(out[0]), [[3.0, 3.0]])
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        T.static.CompiledProgram(main).with_data_parallel(
            places=T.static.cpu_places(2))


def _reshape_program(P, slot, shapes):
    prog = P.Program()
    blk = prog.global_block
    blk.create_var(name="x", shape=(2, 6), dtype="float32")
    names = []
    for i, s in enumerate(shapes):
        n = f"s{i}"
        blk.create_var(name=n, dtype="int32")
        blk.append_op("assign_value", {}, {"Out": [n]},
                      {"shape": [len(s)], "dtype": "int32",
                       "int32_values": list(s)})
        names.append(n)
    blk.append_op("reshape2", {"X": ["x"], slot: names},
                  {"Out": ["out"], "XShape": ["xs"]}, {"shape": [12]})
    return prog


@pytest.mark.parametrize("slot,shapes,want", [
    ("ShapeTensor", [[3], [4]], (3, 4)),
    ("Shape", [[0, 3, -1]], (2, 3, 2)),
    ("ShapeTensor", [[2, 3], [2]], (12,)),
], ids=["scalars", "one_tensor", "mixed_keeps_attr"])
def test_reshape2_with_a_shape_tensor(slot, shapes, want):
    x = np.arange(12, dtype="f4").reshape(2, 6)
    got = {}
    for P in PKGS:
        prog = _reshape_program(P, slot, shapes)
        if P is J:
            got[P] = np.asarray(_jax_eagerly(prog, {"x": x}, ["out"])[0])
        else:
            assert capture_reason(prog)[0] == "shape_tensor"
            got[P] = np.asarray(T.Executor(T.CPUPlace()).run(
                prog, feed={"x": x}, fetch_list=["out"],
                scope=T.framework.Scope())[0])
    np.testing.assert_array_equal(got[T], got[J])
    assert got[T].shape == want


@pytest.mark.parametrize("slot,shapes", [
    ("ShapeTensor", [[2, 3]]), ("ShapeTensorList", [[2], [3]])])
def test_fill_constant_with_a_shape_tensor(slot, shapes):
    got = {}
    for P in PKGS:
        prog = P.Program()
        blk = prog.global_block
        names = []
        for i, s in enumerate(shapes):
            blk.create_var(name=f"s{i}", dtype="int32")
            blk.append_op("assign_value", {}, {"Out": [f"s{i}"]},
                          {"shape": [len(s)], "dtype": "int32",
                           "int32_values": list(s)})
            names.append(f"s{i}")
        blk.append_op("fill_constant", {slot: names}, {"Out": ["out"]},
                      {"shape": [1], "dtype": "float32", "value": 1.5})
        if P is J:
            got[P] = np.asarray(_jax_eagerly(prog, {}, ["out"])[0])
        else:
            assert capture_reason(prog)[0] == "shape_tensor"
            got[P] = np.asarray(T.Executor(T.CPUPlace()).run(
                prog, fetch_list=["out"], scope=T.framework.Scope())[0])
    np.testing.assert_array_equal(got[T], got[J])
    np.testing.assert_array_equal(got[T], np.full((2, 3), 1.5, "f4"))


def test_py_func_runs_the_callable_on_the_host():
    seen = []

    def fn(a):
        seen.append(type(a))
        return np.tanh(a) * 2.0

    got = {}
    for P in PKGS:
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = P.layers.data("x", [3])
            out = main.global_block.create_var(name="pyout", shape=[-1, 3],
                                               dtype="float32")
            P.static.py_func(fn, x, out)
            y = P.layers.scale(out, 0.5)
        exe = P.Executor(P.CPUPlace())
        got[P] = np.asarray(exe.run(
            main, feed={"x": np.array([[0.1, -1.0, 2.0]], "f4")},
            fetch_list=[y], scope=P.framework.Scope())[0])
        if P is T:
            assert capture_reason(main)[0] == "py_func"
    np.testing.assert_allclose(got[T], got[J], rtol=1e-6)
    assert seen[-1] is np.ndarray


def _cond_net(P):
    L = P.layers
    attr = P.param_attr.ParamAttr
    init = P.initializer.ConstantInitializer
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        x = L.data("x", [4])
        flag = L.data("flag", [1])
        h = L.fc(x, 3, param_attr=attr(initializer=init(0.25)),
                 bias_attr=False)
        pred = L.greater_than(L.reduce_sum(flag),
                              L.fill_constant([1], "float32", 0.0))
        out = L.cond(pred,
                     lambda: L.fc(h, 2, param_attr=attr(
                         name="branch_w", initializer=init(0.5)),
                         bias_attr=False),
                     lambda: L.scale(L.reduce_sum(h, dim=1, keep_dim=True)
                                     * L.fill_constant([1, 2], "float32",
                                                       1.0), 2.0))
    return main, startup, out


def test_capture_reasons_and_eager_counts():
    main, startup, out = _cond_net(T)
    assert capture_reason(main) == (
        "control_flow", "op 'cond_pair' reads a value on the host to choose "
                        "what runs, which a graph cannot branch on")
    assert capture_reason(startup) is None
    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(startup, scope=scope)
    before = stat_get("executor_eager_control_flow")
    for flag in (1.0, 0.0):
        exe.run(main, feed={"x": np.ones((2, 4), "f4"),
                            "flag": np.full((1, 1), flag, "f4")},
                fetch_list=[out], scope=scope)
    assert stat_get("executor_eager_control_flow") == before + 2


def test_save_inference_model_of_a_program_with_control_flow(tmp_path):
    """The branch-only parameter is kept by the prune and saved; both
    packages' Predictors serve the port's directory alike."""
    main, startup, out = _cond_net(T)
    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(startup, scope=scope)
    path = str(tmp_path / "cond_model")
    with T.fluid.scope_guard(scope):
        T.fluid.io.save_inference_model(path, ["x", "flag"], [out], exe,
                                        main)
    import os

    assert "branch_w" in os.listdir(path)
    x = np.random.RandomState(0).randn(3, 4).astype("f4")
    tcfg = T.inference.Config(path)
    tcfg.disable_gpu()
    tpred = T.inference.create_predictor(tcfg)
    jpred = J.inference.create_predictor(J.inference.Config(path))
    for flag in (1.0, 0.0):
        feed = {"x": x, "flag": np.full((1, 1), flag, "f4")}
        want = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
        got = tpred.run(feed)[0]
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(jpred.run(feed)[0]),
                                   rtol=1e-6)
