"""PyTorch port: the control-flow lowerings (``while``,
``conditional_block``, ``cond_pair``), ``select_input`` /
``select_output`` and the tensor-array ops against the JAX package (its
``tests/test_control_flow.py`` and ``ops/misc_ops.py``), on the CPU.

- Each program is built the same way in both packages and run by each
  one's executor; integer results and sums of small integers are exact,
  float results are held to 1e-6 relative (float32 products in other
  orders).
- The cond training program runs 10 Momentum steps in both from the JAX
  startup's values: the losses agree within 1e-5 relative (float32 fc
  layers and their gradients summed in other orders, compounded over
  ten steps), and the parameter read only inside a branch moves.
- The JAX package's loud errors hold in the port with the same words; a
  branch that does not run is not run (a ``py_func`` in it is never
  called: its shapes come from the declared vars or ``meta`` tensors).
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_fleet_parity import build_both, run_both

PKGS = [J, T]
IDS = ["jax", "torch"]


def _run(P, main, startup, feed, fetch):
    sc = P.framework.Scope()
    exe = P.Executor(P.CPUPlace())
    exe.run(startup, scope=sc)
    return [np.asarray(v) for v in exe.run(main, feed=feed, fetch_list=fetch,
                                           scope=sc)]


def _both(build, feed, rtol=1e-6):
    """``build(P)`` -> (main, startup, fetch) in both packages; run each;
    the port's fetches equal the JAX package's."""
    got = {}
    for P in PKGS:
        main, startup, fetch = build(P)
        got[P] = _run(P, main, startup, feed, fetch)
    for j, t in zip(got[J], got[T]):
        np.testing.assert_allclose(t, j, rtol=rtol)
    return got[T]


def test_while_sum_to_n():
    def build(P):
        L = P.layers
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            i = L.fill_constant([1], "int64", 0)
            acc = L.fill_constant([1], "int64", 0)
            limit = L.fill_constant([1], "int64", 10)
            def body(i, acc):
                acc = L.elementwise_add(acc, i)
                return L.increment(i), acc

            i, acc = L.while_loop(lambda i, acc: L.less_than(i, limit),
                                  body, [i, acc])
        return main, startup, [acc, i]

    acc, i = _both(build, {})
    assert int(acc.item()) == sum(range(10)) and int(i.item()) == 10


def test_while_tensor_carry():
    """Matrix power by repeated multiply: a tensor-valued carry."""
    def build(P):
        L = P.layers
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = L.data("x", [2, 2], append_batch_size=False)
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 3)
            y = L.elementwise_add(L.fill_constant([2, 2], "float32", 0.0), x)
            i, y = L.while_loop(lambda i, y: L.less_than(i, n),
                                lambda i, y: (L.increment(i),
                                              L.matmul(y, x)), [i, y])
        return main, startup, [y]

    a = np.array([[1.0, 1.0], [0.0, 1.0]], "f4")
    (y,) = _both(build, {"x": a})
    np.testing.assert_allclose(y, np.linalg.matrix_power(a, 4), rtol=1e-6)


def test_while_shape_change_rejected():
    for P in PKGS:
        L = P.layers
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 3)
            y = L.fill_constant([2], "float32", 1.0)
            L.while_loop(lambda i, y: L.less_than(i, n),
                         lambda i, y: (L.increment(i),
                                       L.concat([y, y], axis=0)), [i, y])
        with pytest.raises(Exception, match="loop-invariant shapes/dtypes"):
            _run(P, main, startup, {}, [])


def test_while_context_manager_v18_style():
    def build(P):
        L = P.layers
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            i = L.fill_constant([1], "int64", 0)
            ten = L.fill_constant([1], "int64", 10)
            acc = L.fill_constant([1], "float32", 0.0)
            c = L.less_than(i, ten)
            w = L.While(c)
            with w.block():
                L.assign(L.elementwise_add(acc, L.fill_constant(
                    [1], "float32", 2.0)), acc)
                L.assign(L.increment(i), i)
                L.assign(L.less_than(i, ten), c)
        return main, startup, [acc]

    (acc,) = _both(build, {})
    assert float(acc.item()) == 20.0


@pytest.mark.parametrize("flag,expect", [(1.0, 5.0), (0.0, -5.0)])
def test_cond_both_branches(flag, expect):
    def build(P):
        L = P.layers
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = L.data("x", [1])
            pred = L.greater_than(x, L.fill_constant([1], "float32", 0.5))
            out = L.cond(pred,
                         lambda: L.fill_constant([1], "float32", 5.0),
                         lambda: L.fill_constant([1], "float32", -5.0))
        return main, startup, [out]

    (out,) = _both(build, {"x": np.array([[flag]], "f4")})
    assert float(out.item()) == expect


def test_cond_branch_structure_mismatch_rejected():
    for P in PKGS:
        L = P.layers
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            pred = L.fill_constant([1], "bool", 1)
            with pytest.raises(ValueError, match="different numbers"):
                L.cond(pred, lambda: (L.zeros([1]), L.zeros([1])),
                       lambda: L.zeros([1]))


def test_cond_branch_shapes_disagree_rejected():
    """Branches whose outputs differ in shape raise at the run, whichever
    branch is taken."""
    for P in PKGS:
        L = P.layers
        for flag in (1.0, 0.0):
            main, startup = P.Program(), P.Program()
            with P.program_guard(main, startup):
                x = L.data("x", [1])
                pred = L.greater_than(x, L.fill_constant([1], "float32", 0.5))
                L.cond(pred, lambda: L.fill_constant([2], "float32", 1.0),
                       lambda: L.fill_constant([3], "float32", 1.0))
            with pytest.raises(Exception, match="cond branches disagree on "
                                                "output 0"):
                _run(P, main, startup, {"x": np.array([[flag]], "f4")},
                     [main.global_block.ops[-1].output("Out")[0]])


def _cond_train(P):
    from importlib import import_module

    L = P.layers
    init = P.initializer.ConstantInitializer
    attr = P.param_attr.ParamAttr
    opt = import_module(P.__name__ + ".optimizer")
    main, startup = P.Program(), P.Program()
    main.random_seed = 1
    with P.program_guard(main, startup):
        x = L.data("x", [4])
        y = L.data("y", [1])
        flag = L.data("flag", [1])
        h = L.fc(x, 8, act="relu", param_attr=attr(initializer=init(0.2)),
                 bias_attr=False)
        pred = L.greater_than(L.reduce_sum(flag),
                              L.fill_constant([1], "float32", 0.0))
        out = L.cond(pred,
                     lambda: L.fc(h, 1, param_attr=attr(
                         initializer=init(0.1)), bias_attr=False),
                     lambda: L.reduce_sum(h, dim=1, keep_dim=True))
        loss = L.mean(L.square_error_cost(out, y))
        opt.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("alternate", [False, True],
                         ids=["flag_on", "flag_alternating"])
def test_cond_in_training_grads_flow(alternate, monkeypatch):
    """Parameters read only inside a branch get gradients (the port's
    generic gradient replays ``cond_pair`` under autograd); with the flag
    on the loss halves, as in the JAX test.  The branch that does not run
    is shaped by its declared vars (batch -1), with no meta probe."""
    from paddle_tpu_torch.ops import control_flow

    probes = []
    real = control_flow._to_meta
    monkeypatch.setattr(control_flow, "_to_meta",
                        lambda v: probes.append(1) or real(v))
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype("f4")
    feed = {"x": x, "y": (x.sum(1, keepdims=True) * 0.5).astype("f4")}
    feeds = [dict(feed, flag=np.full(
        (1, 1), float(i % 2 == 0 or not alternate), "f4"))
        for i in range(10)]
    jparts, tparts = build_both(_cond_train)
    want, got, _, tscope = run_both(jparts, tparts, feeds, [jparts[2]])
    losses = [g[0].item() for g in got]
    np.testing.assert_allclose(losses, [w[0].item() for w in want],
                               rtol=1e-5)
    if not alternate:
        assert losses[-1] < losses[0] * 0.5, losses
    w = np.asarray(tscope.get_var("fc_1.w_0").cpu())
    assert not np.allclose(w, 0.1), "no gradient reached the branch param"
    assert not probes


def _sub_program(P, fill, out_prev):
    """A ``conditional_block`` writing ``out`` (5.0s) when ``x`` > 0.5;
    ``out_prev`` gives ``out`` a value before it."""
    prog = P.Program()
    blk = prog.global_block
    blk.create_var(name="x", shape=(1,), dtype="float32")
    blk.create_var(name="c", shape=(1,), dtype="bool")
    blk.create_var(name="half", shape=(1,), dtype="float32")
    blk.create_var(name="out", shape=(2,), dtype="float32")
    blk.append_op("fill_constant", {}, {"Out": ["half"]},
                  {"shape": [1], "dtype": "float32", "value": 0.5})
    blk.append_op("greater_than", {"X": ["x"], "Y": ["half"]},
                  {"Out": ["c"]}, {})
    if out_prev:
        blk.append_op("fill_constant", {}, {"Out": ["out"]},
                      {"shape": [2], "dtype": "float32", "value": -1.0})
    sub = prog._create_block()
    sub.append_op(fill, {}, {"Out": ["out"]},
                  {"shape": [2], "dtype": "float32", "value": 5.0})
    prog._rollback()
    blk.append_op("conditional_block", {"Cond": ["c"]}, {"Out": ["out"]},
                  {"sub_block": sub.idx})
    return prog


@pytest.mark.parametrize("x,out_prev,want", [
    (1.0, False, 5.0), (0.0, True, -1.0), (0.0, False, 0.0)],
    ids=["taken", "keeps_previous", "zeros"])
def test_conditional_block(x, out_prev, want):
    got = {}
    for P in PKGS:
        prog = _sub_program(P, "fill_constant", out_prev)
        exe = P.Executor(P.CPUPlace())
        got[P] = np.asarray(exe.run(prog, feed={"x": np.array([x], "f4")},
                                    fetch_list=["out"],
                                    scope=P.framework.Scope())[0])
    np.testing.assert_array_equal(got[T], got[J])
    np.testing.assert_array_equal(got[T], np.full((2,), want, "f4"))


@pytest.mark.parametrize("probe", [False, True],
                         ids=["declared", "meta_probe"])
def test_untaken_branch_is_not_run(probe, monkeypatch):
    """The branch that does not run is never called, also to find its
    shapes: a py_func in it (which needs values) stays uncalled.  Where
    the branch reads a var off its declared shape (``z``, declared [1],
    fed [4]) its shapes come from the meta probe, which stops at the
    py_func and takes the declared ones."""
    from paddle_tpu_torch.ops import control_flow, misc

    calls, probes = [], []
    real = control_flow._to_meta
    monkeypatch.setattr(control_flow, "_to_meta",
                        lambda v: probes.append(1) or real(v))

    def side(x, *rest):
        calls.append(1)
        return x

    misc.register_py_func(7001, side)
    prog = _sub_program(T, "fill_constant", False)
    prog.global_block.create_var(name="z", shape=(1,), dtype="float32")
    sub = prog.blocks[1]
    sub.append_op("py_func", {"X": ["out"] + ["z"] * probe},
                  {"Out": ["out"]}, {"forward_callable_id": 7001})
    exe = T.Executor(T.CPUPlace())
    feed = {"z": np.ones((4,), "f4")} if probe else {}
    out = exe.run(prog, feed=dict(feed, x=np.array([0.0], "f4")),
                  fetch_list=["out"], scope=T.framework.Scope())
    np.testing.assert_array_equal(np.asarray(out[0]), [0.0, 0.0])
    assert calls == []
    assert bool(probes) == probe
    exe.run(prog, feed=dict(feed, x=np.array([1.0], "f4")),
            fetch_list=["out"], scope=T.framework.Scope())
    assert calls == [1]


def test_condition_of_several_elements_rejected():
    for P in PKGS:
        prog = P.Program()
        blk = prog.global_block
        blk.create_var(name="c", shape=(2,), dtype="bool")
        blk.append_op("fill_constant", {}, {"Out": ["c"]},
                      {"shape": [2], "dtype": "bool", "value": 1.0})
        sub = prog._create_block()
        sub.append_op("fill_constant", {}, {"Out": ["c"]},
                      {"shape": [2], "dtype": "bool", "value": 0.0})
        prog._rollback()
        blk.append_op("while", {"X": ["c"], "Condition": ["c"]},
                      {"Out": ["c"]}, {"sub_block": sub.idx})
        exe = P.Executor(P.CPUPlace())
        with pytest.raises(Exception, match="control-flow condition must be a "
                                            "single element"):
            exe.run(prog, fetch_list=["c"], scope=P.framework.Scope())


@pytest.mark.parametrize("mask", [0, 1, 2])
def test_select_input_and_output(mask):
    """select_output routes X to the masked output (zeros elsewhere);
    select_input picks the masked input."""
    xs = [np.full((2, 3), v, "f4") for v in (1.0, 2.0, 3.0)]
    got = {}
    for P in PKGS:
        prog = P.Program()
        blk = prog.global_block
        for n in ("x0", "x1", "x2", "m", "o0", "o1", "o2", "sel"):
            blk.create_var(name=n)
        blk.append_op("select_output", {"X": ["x0"], "Mask": ["m"]},
                      {"Out": ["o0", "o1", "o2"]}, {})
        blk.append_op("select_input", {"X": ["x0", "x1", "x2"],
                                       "Mask": ["m"]}, {"Out": ["sel"]}, {})
        exe = P.Executor(P.CPUPlace())
        got[P] = exe.run(prog, feed={"x0": xs[0], "x1": xs[1], "x2": xs[2],
                                     "m": np.array([mask], "int32")},
                         fetch_list=["o0", "o1", "o2", "sel"],
                         scope=P.framework.Scope())
    for j, t in zip(got[J], got[T]):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    np.testing.assert_array_equal(np.asarray(got[T][3]), xs[mask])
    np.testing.assert_array_equal(np.asarray(got[T][mask]), xs[0])


def _jax_eagerly(prog, feed, fetch):
    """The JAX lowerings called one by one on concrete arrays: its tensor
    arrays need a concrete index, which a jitted block does not give."""
    import jax.numpy as jnp
    from paddle_tpu.framework.lowering import LoweringContext, get_lowering

    env = {n: jnp.asarray(v) for n, v in feed.items()}
    ctx = LoweringContext(prog.global_block, env, rng_key=None)
    for op in prog.global_block.ops:
        get_lowering(op.type)(ctx, op)
    return [env[n] for n in fetch]


def test_tensor_array_ops():
    """lod_tensor_to_array, write_to_array / read_from_array at a host
    index, lod_array_length and array_to_lod_tensor, against the JAX
    package's lowerings."""
    x = np.arange(12, dtype="f4").reshape(3, 4)
    got = {}
    for P in PKGS:
        prog = P.Program()
        blk = prog.global_block
        for n in ("x", "arr", "i", "row", "arr2", "n", "back", "extra"):
            blk.create_var(name=n)
        blk.append_op("lod_tensor_to_array", {"X": ["x"]}, {"Out": ["arr"]},
                      {})
        blk.append_op("fill_constant", {}, {"Out": ["i"]},
                      {"shape": [1], "dtype": "int64", "value": 1.0})
        blk.append_op("read_from_array", {"X": ["arr"], "I": ["i"]},
                      {"Out": ["row"]}, {})
        blk.append_op("scale", {"X": ["row"]}, {"Out": ["extra"]},
                      {"scale": 10.0})
        blk.append_op("fill_constant", {}, {"Out": ["i"]},
                      {"shape": [1], "dtype": "int64", "value": 3.0})
        blk.append_op("write_to_array", {"X": ["extra"], "I": ["i"]},
                      {"Out": ["arr"]}, {})
        blk.append_op("lod_array_length", {"X": ["arr"]}, {"Out": ["n"]}, {})
        blk.append_op("array_to_lod_tensor", {"X": ["arr"]},
                      {"Out": ["back"]}, {})
        fetch = ["row", "n", "back"]
        if P is J:
            got[P] = [np.asarray(v) for v in _jax_eagerly(prog, {"x": x},
                                                          fetch)]
        else:
            got[P] = [np.asarray(v) for v in T.Executor(T.CPUPlace()).run(
                prog, feed={"x": x}, fetch_list=fetch,
                scope=T.framework.Scope())]
    for j, t in zip(got[J], got[T]):
        np.testing.assert_array_equal(t, j)
    assert int(got[T][1].item()) == 4
    np.testing.assert_array_equal(got[T][2],
                                  np.concatenate([x.ravel(), x[1] * 10]))


def test_gradients_through_while_refused():
    for P in PKGS:
        L = P.layers
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            x = L.data("x", [2])
            x.stop_gradient = False
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 2)
            y = L.scale(x, 1.0)
            i, y = L.while_loop(lambda i, y: L.less_than(i, n),
                                lambda i, y: (L.increment(i), L.scale(y, 2.0)),
                                [i, y])
            with pytest.raises(NotImplementedError, match="while"):
                P.append_backward(L.mean(y))
