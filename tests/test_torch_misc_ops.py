"""PyTorch port: ``ops/misc_ops.py`` (the LoD and SelectedRows shims,
``depthwise_conv2d_transpose``, ``conv3d_transpose``, ``conv_shift``,
``fsp``, ``data_norm``, ``affine_grid``, ``unpool``, ``center_loss``,
``shuffle_batch``, ``batch_fc``, ``broadcast_to``, ``full_like``), each
against the JAX lowering; its select and count ops are in
``test_torch_select_ops.py``.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every float input gradient compared
(``test_torch_lowerings.check_case``); each op's cases run in one test.
The edge cases: ``unpool`` and ``center_loss`` with duplicate, negative
and out-of-range indices (jax's scatter drops them, its gather clamps);
``center_loss`` with ``CentersOut`` written to the persistable
``Centers`` over two runs, against the JAX package's two runs;
``affine_grid`` both ways of ``align_corners``, and with an
``OutputShape`` tensor, which the JAX lowering reads with
``np.asarray`` and its traced executor cannot run: the port's program
(eager, ``shape_tensor``) is held to the JAX lowering given the same
shape as the attribute.  ``shuffle_batch`` draws from different
generators in the two packages, so it is held to being a permutation
with ``Out == X[ShuffleIdx]``; neither package has its gradient.

Tolerance: 1e-5 absolute plus 1e-5 relative (``test_torch_lowerings.TOL``):
float32 on both sides, sums in another order (the transposed
convolutions, ``fsp``'s and ``batch_fc``'s products); the identities,
fills and broadcasts are equal.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
import test_torch_lowerings as tl
from paddle_tpu.framework import program as jprogram
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework.scope import scope_from_numpy
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case

CENTER_OUTS = ["Loss", "SampleCenterDiff", "CentersOut"]


def _cases():
    rs = np.random.RandomState(234)
    theta = randn(rs, 2, 2, 3)
    return {
        "lod_reset": [case("lod_reset", dict(X=[randn(rs, 3, 4)]), ["Out"])],
        "get_tensor_from_selected_rows": [case(
            "get_tensor_from_selected_rows", dict(X=[randn(rs, 3, 4)]),
            ["Out"])],
        "merge_selected_rows": [case("merge_selected_rows",
                                     dict(X=[randn(rs, 4, 2)]), ["Out"])],
        "depthwise_conv2d_transpose": [case(
            "depthwise_conv2d_transpose",
            dict(Input=[randn(rs, 2, 4, 5, 5)],
                 Filter=[randn(rs, 4, 1, 3, 3)]), ["Output"],
            dict(strides=[2, 2], paddings=[1, 1], groups=4),
            grad=["Output"])],
        "conv3d_transpose": [
            case("conv3d_transpose", dict(Input=[randn(rs, 2, 3, 3, 4, 4)],
                                          Filter=[randn(rs, 3, 2, 2, 3, 2)]),
                 ["Output"], dict(strides=[2, 1, 2], paddings=[1, 0, 1],
                                  dilations=[1, 2, 1]), grad=["Output"]),
            case("conv3d_transpose", dict(Input=[randn(rs, 1, 2, 2, 3, 3)],
                                          Filter=[randn(rs, 2, 3, 2, 2, 2)]),
                 ["Output"], dict(strides=[2, 2, 2]), grad=["Output"])],
        "conv_shift": [
            case("conv_shift", dict(X=[randn(rs, 3, 7)], Y=[randn(rs, 3, 3)]),
                 ["Out"]),
            case("conv_shift", dict(X=[randn(rs, 2, 5)], Y=[randn(rs, 2, 4)]),
                 ["Out"])],
        "fsp": [case("fsp", dict(X=[randn(rs, 2, 3, 4, 5)],
                                 Y=[randn(rs, 2, 6, 4, 5)]), ["Out"])],
        "data_norm": [case("data_norm", dict(
            X=[randn(rs, 8, 5)], BatchSize=[rs.rand(5).astype("f4") * 1e3
                                            + 1e4],
            BatchSum=[randn(rs, 5) * 100],
            BatchSquareSum=[rs.rand(5).astype("f4") * 1e4 + 1e4]),
            ["Y", "Means", "Scales"], dict(epsilon=1e-4),
            grad=["Y", "Means", "Scales"])],
        "affine_grid": [
            case("affine_grid", dict(Theta=[theta]), ["Output"],
                 dict(output_shape=[2, 3, 5, 7], align_corners=ac),
                 grad=["Output"]) for ac in (True, False)],
        "unpool": [case("unpool", dict(
            X=[randn(rs, 2, 3, 3, 4)],
            Indices=[rs.randint(-5, 55, (2, 3, 3, 4)).astype("int32")]),
            ["Out"], dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0]))],
        "center_loss": [
            case("center_loss", dict(
                X=[randn(rs, 6, 4)],
                Label=[np.array([[1], [3], [1], [9], [-1], [0]], "int64")],
                Centers=[randn(rs, 5, 4)],
                CenterUpdateRate=[np.array([0.3], "f4")]), CENTER_OUTS,
                dict(need_update=True), grad=CENTER_OUTS),
            case("center_loss", dict(
                X=[randn(rs, 3, 4)], Label=[np.array([[0], [2], [2]],
                                                     "int64")],
                Centers=[randn(rs, 3, 4)]), CENTER_OUTS,
                dict(need_update=False), grad=["Loss", "SampleCenterDiff"])],
        "batch_fc": [
            case("batch_fc", dict(Input=[randn(rs, 3, 4, 5)],
                                  W=[randn(rs, 3, 5, 2)],
                                  Bias=[randn(rs, 3, 1, 2)]), ["Out"]),
            case("batch_fc", dict(Input=[randn(rs, 2, 3, 4)],
                                  W=[randn(rs, 2, 4, 3)]), ["Out"])],
        "broadcast_to": [
            case("broadcast_to", dict(X=[randn(rs, 3, 1)]), ["Out"],
                 dict(shape=[2, -1, 4])),
            case("broadcast_to", dict(X=[randn(rs, 4)]), ["Out"],
                 dict(shape=[3, 4]))],
        "full_like": [
            case("full_like", dict(X=[randn(rs, 2, 3)]), ["Out"],
                 dict(value=2.5), grad=[]),
            case("full_like", dict(X=[randn(rs, 2, 3)]), ["Out"],
                 dict(value=7.0, dtype=3), grad=[])],
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_misc_lowering_matches_jax(name):
    for i, c in enumerate(CASES[name]):
        check_case(f"{name}_{i}", c)


def test_affine_grid_output_shape_tensor_is_read_on_the_host():
    """``OutputShape`` as a tensor: held to the JAX lowering given the
    same shape as the attribute; the program runs eagerly."""
    want = check_case("affine_grid_attr", CASES["affine_grid"][1])
    theta = CASES["affine_grid"][1]["inputs"]["Theta"][0]
    c = case("affine_grid", dict(Theta=[theta], OutputShape=[np.array(
        [2, 3, 5, 7], "int32")]), ["Output"], dict(align_corners=False))
    prog, feed, fetch = tl._build("torch", c)
    assert texecutor.capture_reason(prog)[0] == "shape_tensor"
    got = tl._run("torch", prog, feed, fetch)[0]
    np.testing.assert_array_equal(got, want["out_output"][0])
    np.testing.assert_allclose(got, want["out_output"][1], **tl.TOL)


def _center_program(prog_mod, values):
    prog = prog_mod.Program()
    blk = prog.global_block
    for name, a in values.items():
        blk.create_var(name=name, shape=a.shape, dtype=a.dtype.name,
                       persistable=name == "centers")
    for n in ("loss", "diff"):
        blk.create_var(name=n)
    blk.append_op("center_loss",
                  {"X": ["x"], "Label": ["label"], "Centers": ["centers"],
                   "CenterUpdateRate": ["rate"]},
                  {"Loss": ["loss"], "SampleCenterDiff": ["diff"],
                   "CentersOut": ["centers"]}, {"need_update": True})
    return prog


def test_center_loss_updates_persistable_centers_over_two_runs():
    """``CentersOut`` named as the persistable ``Centers``: each run reads
    the centers the last one wrote, in both packages alike."""
    rs = np.random.RandomState(3)
    values = {"x": randn(rs, 8, 4), "label": np.array(
        [[0], [2], [2], [1], [4], [2], [0], [7]], "int64"),
        "centers": randn(rs, 5, 4), "rate": np.array([0.5], "f4")}
    feed = {k: values[k] for k in ("x", "label", "rate")}
    jscope = J.framework.Scope()
    jscope.set_var("centers", values["centers"])
    tscope = scope_from_numpy({"centers": values["centers"]}, device="cpu")
    jexe, texe = J.Executor(J.CPUPlace()), T.Executor(T.CPUPlace())
    jprog = _center_program(jprogram, values)
    tprog = _center_program(tprogram, values)
    snaps = []
    for _ in range(2):
        jl = jexe.run(jprog, feed=feed, fetch_list=["loss"], scope=jscope)[0]
        tloss = texe.run(tprog, feed=feed, fetch_list=["loss"],
                         scope=tscope)[0]
        jc = np.array(jscope.get_var("centers"))
        tc = tscope.get_var("centers").clone().numpy()
        np.testing.assert_allclose(tloss, np.asarray(jl), **tl.TOL)
        np.testing.assert_allclose(tc, jc, **tl.TOL)
        snaps.append(tc)
    assert not np.allclose(snaps[0], snaps[1])
    assert not np.allclose(snaps[0], values["centers"])


def test_shuffle_batch_is_a_permutation_of_the_rows():
    """``Out == X[ShuffleIdx]``, ``ShuffleIdx`` an int32 permutation, and
    the program's stream moves on between runs."""
    x = np.arange(64 * 3, dtype="f4").reshape(64, 3)
    c = case("shuffle_batch", dict(X=[x], Seed=[np.array([5], "int64")]),
             ["Out", "ShuffleIdx", "SeedOut"], grad=[])
    prog, feed, fetch = tl._build("torch", c)
    exe, scope = T.Executor(T.CPUPlace()), T.framework.Scope()
    runs = [exe.run(prog, feed=feed, fetch_list=fetch[:2], scope=scope)
            for _ in range(2)]
    for out, idx in runs:
        assert idx.dtype == np.int32
        assert sorted(idx.tolist()) == list(range(64))
        np.testing.assert_array_equal(out, x[idx])
    assert (runs[0][1] != runs[1][1]).any()


def test_no_shuffle_batch_gradient_in_either_package():
    """The generic gradient replays the forward without a generator: a
    ``shuffle_batch`` gradient raises in both packages."""
    c = case("shuffle_batch", dict(X=[np.ones((4, 2), "f4")]), ["Out"])
    cots = {"out_out": np.ones((4, 2), "f4")}
    for which in ("jax", "torch"):
        with pytest.raises(Exception, match="random ops"):
            tl._run(which, *tl._build(which, c, cots))


def test_conv3d_transpose_refuses_groups():
    c = case("conv3d_transpose", dict(Input=[np.ones((1, 4, 2, 2, 2), "f4")],
                                      Filter=[np.ones((4, 1, 2, 2, 2), "f4")]),
             ["Output"], dict(groups=4), grad=[])
    with pytest.raises(NotImplementedError, match="groups"):
        tl._run("torch", *tl._build("torch", c))
