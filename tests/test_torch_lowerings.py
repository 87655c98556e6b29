"""PyTorch port: the op lowerings of the static BERT program.

One parametrised test over the op types that BERT-base pretraining under
bfloat16 AMP runs (forward, backward and the AdamW update; the startup
program's ``fill_constant``); the op types that the unfused attention chain
and the graph passes add are cases of the same check in
``test_torch_lowerings_unfused.py``.  Each case is a one-op program, built with
each package's own IR, with the gradient op appended by the grad maker
that ``append_backward`` would pick (the generic ``<type>_grad``, or the
op's own: ``mean_grad``, ``dropout_grad``, ``reshape_like_grad``,
``softmax_with_cross_entropy_grad``).  Both programs run on the CPU, one
through the JAX package's Executor and one through the port's, with the
same numpy inputs and output cotangents; every output and every input
gradient is compared.

Tolerance: 1e-5 absolute plus 1e-5 relative.  Both sides compute in
float32 and differ only in summation order and in the last bits of
their transcendental functions, on values of order 1.  The bfloat16
outputs of ``cast`` are exact roundings of the same float32 values.
A case may state its own tolerance (``tol``).

Random ops (``dropout`` with a nonzero rate, ``gaussian_random``) draw
from different generators in the two packages, so they are held to
their statistics instead.  The JAX package truncates int64 feeds to
int32 and the port keeps them, which no comparison below can see.
"""
import numpy as np
import pytest
import torch

import ml_dtypes
import paddle_tpu as jpkg
import paddle_tpu_torch as tpkg
from paddle_tpu.framework import backward as jbackward
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import program as jprogram
from paddle_tpu.ops import fused as jfused
from paddle_tpu_torch.framework import backward as tbackward
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.ops import flash_attention_bias as fab
from paddle_tpu_torch.ops import fused as tfused

TOL = dict(atol=1e-5, rtol=1e-5)
PACKAGES = {"jax": (jpkg, jprogram, jbackward),
            "torch": (tpkg, tprogram, tbackward)}


def _f(rs, *shape, lo=None):
    a = rs.randn(*shape).astype("f4")
    return np.abs(a) + lo if lo is not None else a


def _case(op_type, inputs, outs, attrs=None, grad=("Out",), flash=False,
          tol=None):
    return dict(type=op_type, inputs=inputs, outs=list(outs),
                attrs=dict(attrs or {}), grad=list(grad), flash=flash,
                tol=tol or TOL)


def _cases():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 10, (2, 3)).astype("int64")
    ids[0, 0] = 3
    mask = np.where(rs.rand(2, 1, 1, 128) < 0.1, -1e4, 0.0).astype("f4")
    qkv = [_f(rs, 2, 128, 128) * 0.5 for _ in range(3)]
    labels = rs.randint(0, 10, (6, 1)).astype("int64")
    labels[2, 0] = -100        # ignore_index: zero loss and zero gradient
    mha = dict(Q=[qkv[0]], K=[qkv[1]], V=[qkv[2]], BiasQK=[mask])
    return {
        "lookup_table_v2": _case(
            "lookup_table_v2", dict(W=[_f(rs, 10, 4)], Ids=[ids]), ["Out"],
            dict(padding_idx=-1, is_sparse=False)),
        "lookup_table_v2_padding_idx": _case(
            "lookup_table_v2", dict(W=[_f(rs, 10, 4)], Ids=[ids]), ["Out"],
            dict(padding_idx=3, is_sparse=False)),
        "elementwise_add": _case(
            "elementwise_add", dict(X=[_f(rs, 2, 3, 4)], Y=[_f(rs, 4)]),
            ["Out"], dict(axis=-1)),
        "elementwise_add_axis": _case(
            "elementwise_add", dict(X=[_f(rs, 2, 3, 4)], Y=[_f(rs, 3)]),
            ["Out"], dict(axis=1)),
        "elementwise_mul": _case(
            "elementwise_mul", dict(X=[_f(rs, 6, 1)], Y=[_f(rs, 6, 1)]),
            ["Out"], dict(axis=-1)),
        "elementwise_div": _case(
            "elementwise_div",
            dict(X=[_f(rs, 2, 3)], Y=[_f(rs, 2, 3, lo=0.5)]), ["Out"],
            dict(axis=-1)),
        "elementwise_max": _case(   # BERT's max(sum(weights), ones([1]))
            "elementwise_max", dict(X=[np.float32(4.5).reshape(())],
                                    Y=[np.ones(1, "f4")]), ["Out"],
            dict(axis=-1)),
        "elementwise_max_tensor": _case(
            "elementwise_max", dict(X=[_f(rs, 3, 4)], Y=[_f(rs, 3, 4)]),
            ["Out"], dict(axis=-1)),
        "layer_norm": _case(
            "layer_norm", dict(X=[_f(rs, 2, 5, 8) * 3 + 1],
                               Scale=[_f(rs, 8)], Bias=[_f(rs, 8)]),
            ["Y", "Mean", "Variance"], dict(epsilon=1e-5, begin_norm_axis=2),
            grad=["Y"]),
        "dropout_rate_0": _case(
            "dropout", dict(X=[_f(rs, 4, 5)]), ["Out", "Mask"],
            dict(dropout_prob=0.0, is_test=False, seed=0,
                 dropout_implementation="downgrade_in_infer")),
        "dropout_is_test": _case(
            "dropout", dict(X=[_f(rs, 4, 5)]), ["Out", "Mask"],
            dict(dropout_prob=0.1, is_test=True, seed=0,
                 dropout_implementation="downgrade_in_infer")),
        "mul": _case(
            "mul", dict(X=[_f(rs, 2, 3, 8)], Y=[_f(rs, 8, 5)]), ["Out"],
            dict(x_num_col_dims=2, y_num_col_dims=1)),
        "fused_multihead_attention": _case(
            "fused_multihead_attention", mha, ["Out"],
            dict(head_number=2, alpha=0.0)),
        "fused_multihead_attention_flash": _case(
            "fused_multihead_attention", mha, ["Out"],
            dict(head_number=2, alpha=0.0), flash=True),
        "gelu": _case("gelu", dict(X=[_f(rs, 3, 7) * 2]), ["Out"],
                      dict(approximate=False)),
        "gelu_tanh": _case("gelu", dict(X=[_f(rs, 3, 7) * 2]), ["Out"],
                           dict(approximate=True)),
        "tanh": _case("tanh", dict(X=[_f(rs, 3, 7)]), ["Out"]),
        "reshape2": _case(
            "reshape2", dict(X=[_f(rs, 2, 3, 4)]), ["Out", "XShape"],
            dict(shape=[0, 12])),
        "gather": _case(
            "gather", dict(X=[_f(rs, 6, 4)],
                           Index=[np.array([5, 0, 2, 2], "int64")]),
            ["Out"]),
        "slice": _case(
            "slice", dict(Input=[_f(rs, 2, 3, 4)]), ["Out"],
            dict(axes=[1], starts=[0], ends=[1])),
        "slice_decrease_axis": _case(
            "slice", dict(Input=[_f(rs, 2, 3, 4)]), ["Out"],
            dict(axes=[1, 2], starts=[1, -3], ends=[2, 100],
                 decrease_axis=[1])),
        "softmax_with_cross_entropy": _case(
            "softmax_with_cross_entropy",
            dict(Logits=[_f(rs, 6, 10) * 2], Label=[labels]),
            ["Softmax", "Loss"],
            dict(soft_label=False, ignore_index=-100, axis=-1),
            grad=["Loss"]),
        "reduce_sum_all": _case(
            "reduce_sum", dict(X=[_f(rs, 6, 1)]), ["Out"],
            dict(keep_dim=False, reduce_all=True)),
        "reduce_sum_dim": _case(
            "reduce_sum", dict(X=[_f(rs, 2, 3, 4)]), ["Out"],
            dict(dim=[1], keep_dim=True, reduce_all=False)),
        "mean": _case("mean", dict(X=[_f(rs, 3, 4)]), ["Out"]),
        "fill_constant": _case(
            "fill_constant", {}, ["Out"],
            dict(shape=[2, 3], dtype=1, value=1.5), grad=[]),
        "cast_to_bfloat16": _case(
            "cast", dict(X=[_f(rs, 3, 5)]), ["Out"], dict(out_dtype=4)),
        "cast_from_bfloat16": _case(
            "cast", dict(X=[_f(rs, 3, 5).astype(ml_dtypes.bfloat16)]),
            ["Out"], dict(out_dtype=1)),
        "sum": _case("sum", dict(X=[_f(rs, 3, 4) for _ in range(3)]),
                     ["Out"]),
        "adamw": _case(
            "adamw", dict(Param=[_f(rs, 4, 3)], Grad=[_f(rs, 4, 3)],
                          Moment1=[_f(rs, 4, 3) * 0.1],
                          Moment2=[_f(rs, 4, 3, lo=0.01) * 0.1],
                          Beta1Pow=[np.array([0.9 ** 3], "f4")],
                          Beta2Pow=[np.array([0.999 ** 3], "f4")],
                          LearningRate=[np.array([1e-2], "f4")]),
            ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
             "Beta2PowOut"],
            # lr and decay large enough that each term moves the result
            # well past the tolerance
            dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.1,
                 with_decay=True), grad=[]),
    }


CASES = _cases()


def _build(which, case, cotangents=None):
    """One-op program of ``case`` in package ``which``; with cotangents,
    the op's gradient op after it.  Returns (program, feed, fetch)."""
    _pkg, prog_mod, bw = PACKAGES[which]
    prog = prog_mod.Program()
    blk = prog.global_block
    feed, ins = {}, {}
    for slot, arrays in case["inputs"].items():
        ins[slot] = []
        for i, a in enumerate(arrays):
            name = f"{slot.lower()}_{i}"
            blk.create_var(name=name, shape=a.shape, dtype=a.dtype.name,
                           stop_gradient=False)
            feed[name] = a
            ins[slot].append(name)
    outs = {s: [f"out_{s.lower()}"] for s in case["outs"]}
    for (name,) in outs.values():
        blk.create_var(name=name)
    op = blk.append_op(case["type"], ins, outs, case["attrs"])
    fetch = [n for (n,) in outs.values()]
    if cotangents:
        out_grads = {}
        for name, cot in cotangents.items():
            gname = prog_mod.grad_var_name(name)
            blk.create_var(name=gname, shape=cot.shape, dtype=cot.dtype.name)
            feed[gname] = cot
            out_grads[name] = gname
        bctx = bw.BackwardContext(blk, ())
        gop = bw.GRAD_MAKERS.get(op.type, bw.default_grad_maker)(
            bctx, op, out_grads)
        for slot, names in gop.outputs.items():
            resolved = []
            for n in names:
                if n.startswith("__pending__"):
                    src = n[len("__pending__"):]
                    n = prog_mod.grad_var_name(src)
                    bctx.ensure_grad_var(n, src)
                resolved.append(n)
            gop.outputs[slot] = resolved
        blk.ops.append(gop)
        prog._bump()
        fetch += [n for ns in gop.outputs.values() for n in ns if n]
    return prog, feed, fetch


def _run(which, prog, feed, fetch):
    pkg = PACKAGES[which][0]
    exe = pkg.Executor(pkg.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=fetch,
                   scope=pkg.framework.Scope())


class _flash:
    """Engage B1 in both packages for one case (interpret mode on the
    JAX side, as tests/test_pallas_attention.py does; the plain version
    behind the wrapper on the port's CPU tensors)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        if self.on:
            jfused._FORCE_INTERPRET = tfused._FORCE_ENGAGE = True
            jflags.set_flags({"FLAGS_flash_attention": "always"})
            tpkg.set_flags({"FLAGS_flash_attention": "always"})

    def __exit__(self, *exc):
        jfused._FORCE_INTERPRET = tfused._FORCE_ENGAGE = False
        jflags.set_flags({"FLAGS_flash_attention": "auto"})
        tpkg.set_flags({"FLAGS_flash_attention": "auto"})


def _f32(a):
    a = np.asarray(a)
    return a.astype("f4") if a.dtype == ml_dtypes.bfloat16 else a


def check_case(name, case):
    """Run ``case`` through both packages and compare every output and
    every input gradient (shared with test_torch_lowerings_unfused.py)."""
    with _flash(case["flash"]):
        # the outputs' shapes and types, to make their cotangents
        prog, feed, fetch = _build("torch", case)
        probe = dict(zip(fetch, _run("torch", prog, feed, fetch)))
        rs = np.random.RandomState(1)
        cots = {}
        for slot in case["grad"]:
            out = probe[f"out_{slot.lower()}"]
            cots[f"out_{slot.lower()}"] = np.asarray(
                rs.randn(*out.shape)).astype(out.dtype)
        fab.reset_launch_count()
        got = _run("torch", *_build("torch", case, cots))
        want = _run("jax", *_build("jax", case, cots))
    _prog, _feed, fetch = _build("torch", case, cots)
    assert len(got) == len(want) == len(fetch)
    assert len(fetch) > len(case["outs"]) or not case["grad"]
    for n, g, w in zip(fetch, got, want):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape, (n, g.shape, w.shape)
        if name.startswith("dropout") and n == "out_mask":
            g, w = g.astype("f4"), w.astype("f4")
        np.testing.assert_allclose(g, w, err_msg=n, **case["tol"])
    assert fab.flash_attention_bias.launches == 0   # CPU tensors


@pytest.mark.parametrize("name", sorted(CASES))
def test_lowering_matches_jax(name):
    check_case(name, CASES[name])


def _one_op(op_type, inputs, outs, attrs, seed=7):
    """Build and run a one-op program in the port only."""
    prog = tprogram.Program()
    prog.random_seed = seed
    blk = prog.global_block
    feed = {}
    for slot, a in inputs.items():
        blk.create_var(name=slot.lower(), shape=a.shape, dtype=a.dtype.name)
        feed[slot.lower()] = a
    for s in outs:
        blk.create_var(name=s.lower())
    blk.append_op(op_type, {s: [s.lower()] for s in inputs},
                  {s: [s.lower()] for s in outs}, attrs)
    exe = tpkg.Executor(tpkg.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=[s.lower() for s in outs],
                   scope=tpkg.framework.Scope())


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_statistics(impl):
    """Dropout draws its mask from the port's generator: the kept share
    is 1 - p within 5 standard deviations of a binomial draw, kept
    elements are X (``downgrade_in_infer``) or X / (1 - p)
    (``upscale_in_train``), dropped ones 0, and the Mask marks them."""
    x = np.random.RandomState(0).rand(200, 500).astype("f4") + 1.0
    p = 0.1
    out, mask = _one_op("dropout", {"X": x}, ["Out", "Mask"],
                        dict(dropout_prob=p, is_test=False, seed=0,
                             dropout_implementation=impl))
    keep = mask.astype(bool)
    n = x.size
    assert abs(keep.mean() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    scale = 1.0 if impl == "downgrade_in_infer" else 1.0 / (1 - p)
    np.testing.assert_allclose(out[keep], x[keep] * scale, rtol=1e-6)
    assert np.all(out[~keep] == 0)


def test_dropout_seed_attr_fixes_the_mask():
    """A nonzero ``seed`` attr gives the op its own stream: two runs
    agree; the program's stream (seed 0) moves on between runs."""
    x = np.ones((64, 64), "f4")
    attrs = dict(dropout_prob=0.5, is_test=False,
                 dropout_implementation="downgrade_in_infer")
    a = _one_op("dropout", {"X": x}, ["Mask"], dict(attrs, seed=11))[0]
    b = _one_op("dropout", {"X": x}, ["Mask"], dict(attrs, seed=11))[0]
    np.testing.assert_array_equal(a, b)
    prog = tprogram.Program()
    prog.random_seed = 3
    blk = prog.global_block
    blk.create_var(name="x", shape=x.shape, dtype="float32")
    for n in ("out", "mask"):
        blk.create_var(name=n)
    blk.append_op("dropout", {"X": ["x"]}, {"Out": ["out"], "Mask": ["mask"]},
                  dict(attrs, seed=0))
    exe, scope = tpkg.Executor(tpkg.CPUPlace()), tpkg.framework.Scope()
    m1 = exe.run(prog, feed={"x": x}, fetch_list=["mask"], scope=scope)[0]
    m2 = exe.run(prog, feed={"x": x}, fetch_list=["mask"], scope=scope)[0]
    assert not np.array_equal(m1, m2)


def test_gaussian_random_statistics():
    """The startup program's initializer: mean and std within 5 standard
    errors of the requested ones, in the requested type and shape."""
    prog = tprogram.Program()
    prog.random_seed = 5
    blk = prog.global_block
    blk.create_var(name="w", shape=(300, 400), dtype="float32",
                   persistable=True)
    blk.append_op("gaussian_random", {}, {"Out": ["w"]},
                  dict(shape=[300, 400], mean=0.5, std=0.02, dtype=1,
                       seed=0))
    exe, scope = tpkg.Executor(tpkg.CPUPlace()), tpkg.framework.Scope()
    exe.run(prog, scope=scope)
    w = scope.get_var("w")
    assert w.dtype == torch.float32 and tuple(w.shape) == (300, 400)
    n = w.numel()
    assert abs(float(w.mean()) - 0.5) < 5 * 0.02 / np.sqrt(n)
    assert abs(float(w.std()) - 0.02) < 5 * 0.02 / np.sqrt(2 * n)


def test_op_without_a_lowering_names_a_later_slice():
    prog = tprogram.Program()
    blk = prog.global_block
    blk.create_var(name="x", shape=(2, 2), dtype="float32")
    blk.create_var(name="y")
    blk.append_op("conv2d", {"Input": ["x"]}, {"Output": ["y"]}, {})
    exe = tpkg.Executor(tpkg.CPUPlace())
    with pytest.raises(NotImplementedError,
                       match="'conv2d'.*later slice of the port"):
        exe.run(prog, feed={"x": np.ones((2, 2), "f4")}, fetch_list=["y"],
                scope=tpkg.framework.Scope())


def test_sequence_parallel_attention_is_refused():
    case = CASES["fused_multihead_attention"]
    case = dict(case, attrs=dict(case["attrs"], sequence_parallel=True))
    prog, feed, fetch = _build("torch", case)
    with pytest.raises(NotImplementedError, match="later slice"):
        _run("torch", prog, feed, fetch)
