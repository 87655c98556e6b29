"""PyTorch port: the weight-only quantization pass
(``paddle_tpu_torch/slim/quantization.py``) through the executor, run side
by side with the JAX package (ports of
``tests/test_quant_inference.py:145-231``).

Both packages start from the same values: the JAX startup's, carried over
with ``scope_from_numpy``.  Their carriers and scales are then equal bit for
bit (``quantize_weight`` is), and their quantized outputs agree within 1e-5
absolute (float32 summation order over 16-wide layers of O(1) values).
The port's own invariants are held exactly: flipping the flag back serves
the float program bit for bit, and a float8 carrier reaches the lowering as
``float8_e4m3fn`` although the block declares it ``int8``.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpkg
from paddle_tpu import layers as jlayers
from paddle_tpu.framework import dtypes as jdtypes
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.initializer import ConstantInitializer as JConstant
from paddle_tpu.monitor import stat_get as jstat
from paddle_tpu.param_attr import ParamAttr as JParamAttr
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.framework import dtypes as tdtypes
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import scope_from_numpy, to_numpy
from paddle_tpu_torch.initializer import ConstantInitializer as TConstant
from paddle_tpu_torch.monitor import stat_get as tstat
from paddle_tpu_torch.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.slim import PostTrainingWeightQuantPass, \
    mark_weight_quant

TOL = 1e-5
ParamAttr = {"jax": JParamAttr, "torch": TParamAttr}
Constant = {"jax": JConstant, "torch": TConstant}
PKG = {"jax": (jpkg, jlayers, jprogram, jdtypes, jstat),
       "torch": (tpkg, tlayers, tprogram, tdtypes, tstat)}


@pytest.fixture(autouse=True)
def _flags_off():
    yield
    for pkg, *_ in PKG.values():
        pkg.set_flags({"FLAGS_weight_quant": ""})


def _set_mode(mode):
    for pkg, *_ in PKG.values():
        pkg.set_flags({"FLAGS_weight_quant": mode})


def _fc_program(which, depth=2, width=16, seed=3):
    _pkg, layers, program, *_ = PKG[which]
    main, startup = program.Program(), program.Program()
    main.random_seed = seed
    with program_guard(program, main, startup):
        x = layers.data("x", [width])
        h = x
        for _ in range(depth):
            h = layers.fc(h, width, act="tanh")  # (no relu lowering yet)
    return main, startup, h


@contextlib.contextmanager
def program_guard(program, main, startup):
    """Either package's program_guard under fresh unique names."""
    unique = junique if program is jprogram else tunique
    with unique.guard(), program.program_guard(main, startup):
        yield


def _pair(builder, **kw):
    """The program built in both packages, each with a scope holding the
    JAX startup's values, and an executor on the CPU."""
    out = {}
    jmain, jstart, jh = builder("jax", **kw)
    jexe, jscope = jpkg.Executor(jpkg.CPUPlace()), jpkg.framework.Scope()
    jexe.run(jstart, scope=jscope)
    values = {n: np.asarray(jscope.get_var(n))
              for n in jscope.local_var_names()
              if jscope.get_var(n) is not None and not n.startswith("@")}
    out["jax"] = (jmain, jh, jexe, jscope)
    tmain, _tstart, th = builder("torch", **kw)
    out["torch"] = (tmain, th, tpkg.Executor(tpkg.CPUPlace()),
                    scope_from_numpy(values, device="cpu"))
    return out


def _run(pair, which, feed):
    main, h, exe, scope = pair[which]
    return np.asarray(exe.run(main, feed=feed, fetch_list=[h],
                              scope=scope)[0])


def _carrier_bits(scope, name):
    v = scope.get_var(name)
    return np.asarray(to_numpy(v) if isinstance(v, torch.Tensor) else v) \
        .view(np.uint8)


def test_flag_gated_end_to_end():
    """FLAGS_weight_quant rewrites the matmul-family ops to dequant_matmul
    with int8 carriers + per-channel scales in scope; the output stays
    close and equals the JAX package's; flipping the flag back re-keys the
    cache and reproduces the float path BITWISE."""
    pair = _pair(_fc_program)
    feed = {"x": np.random.RandomState(0).randn(4, 16).astype("f4")}
    base = {w: _run(pair, w, feed) for w in PKG}
    np.testing.assert_allclose(base["torch"], base["jax"], rtol=0, atol=TOL)
    n0 = {w: PKG[w][4]("pass_weight_quant_ops") for w in PKG}
    _set_mode("int8")
    q = {w: _run(pair, w, feed) for w in PKG}
    _set_mode("")
    for w in PKG:
        assert PKG[w][4]("pass_weight_quant_ops") - n0[w] == 2
    scope = pair["torch"][3]
    assert scope.has_var("fc_0.w_0@WQ") and scope.has_var("fc_0.w_0@WQ_SCALE")
    assert scope.get_var("fc_0.w_0@WQ").dtype == torch.int8
    for name in ("fc_0.w_0@WQ", "fc_1.w_0@WQ_SCALE"):
        assert np.array_equal(_carrier_bits(scope, name),
                              _carrier_bits(pair["jax"][3], name))
    assert np.abs(q["torch"] - base["torch"]).max() < \
        0.05 * max(np.abs(base["torch"]).max(), 1.0)
    np.testing.assert_allclose(q["torch"], q["jax"], rtol=0, atol=TOL)
    back = _run(pair, "torch", feed)
    assert np.array_equal(back, base["torch"])


def test_mark_weight_quant_per_program_without_flag():
    pair = _pair(_fc_program, depth=1, seed=4)
    mark_weight_quant(pair["torch"][0], "int8")
    feed = {"x": np.ones((2, 16), "f4")}
    out = _run(pair, "torch", feed)
    scope = pair["torch"][3]
    assert scope.has_var("fc_0.w_0@WQ")
    assert np.isfinite(out).all()
    assert all(op.attr("__weight_quant__") == "int8"
               for op in pair["torch"][0].global_block.ops
               if op.type == "mul")
    with pytest.raises(ValueError, match="unknown weight-quant mode"):
        mark_weight_quant(pair["torch"][0], "int3")


def _cast_program(which, seed=5):
    """One fc whose weight is read through an AMP-style cast."""
    _pkg, layers, program, dtypes, _stat = PKG[which]
    main, startup = program.Program(), program.Program()
    main.random_seed = seed
    with program_guard(program, main, startup):
        x = layers.data("x", [8])
        h = layers.fc(x, 8, bias_attr=False)
    block = main.global_block
    (op,) = [o for o in block.ops if o.type == "mul"]
    wname = op.input("Y")[0]
    cast_out = block.create_var(name=wname + ".cast", dtype="float32",
                                stop_gradient=False)
    block.ops.insert(
        block.ops.index(op),
        program.Operator(block, "cast", {"X": [wname]},
                         {"Out": [cast_out.name]},
                         {"out_dtype": dtypes.to_enum("float32")}))
    op._rename_input(wname, cast_out.name)
    main._bump()
    return main, startup, h


def test_weight_resolves_through_amp_cast():
    """A weight read through an AMP-style cast is quantized at the source;
    the orphaned cast is dropped by DCE, as in the JAX package."""
    pair = _pair(_cast_program)
    feed = {"x": np.random.RandomState(1).randn(4, 8).astype("f4")}
    base = _run(pair, "torch", feed)
    _set_mode("int8")
    q = {w: _run(pair, w, feed) for w in PKG}
    main, h, _exe, scope = pair["torch"]
    rewritten = tpasses.apply_passes(main, fetch_names=(h.name,),
                                     feed_names=("x",), scope=scope)
    _set_mode("")
    assert scope.has_var("fc_0.w_0@WQ")
    assert [op.type for op in rewritten.global_block.ops] == \
        ["dequant_matmul"]
    assert np.abs(q["torch"] - base).max() < \
        0.05 * max(np.abs(base).max(), 1.0)
    np.testing.assert_allclose(q["torch"], q["jax"], rtol=0, atol=TOL)


def _skip_program(which, seed=6):
    """matmul_v2 on a transposed weight, and a mul with y_num_col_dims=2:
    both stay unquantized, beside one fc that is quantized (the pass
    counts its skips when it rewrites anything)."""
    _pkg, layers, program, *_ = PKG[which]
    main, startup = program.Program(), program.Program()
    main.random_seed = seed
    with program_guard(program, main, startup):
        x = layers.data("x", [8])
        blk = main.global_block
        for name, shape in (("wt", [6, 8]), ("w3", [4, 2, 3])):
            p = blk.create_parameter(name, shape, dtype="float32")
            startup.global_block.create_var(name=name, shape=shape,
                                            dtype="float32",
                                            persistable=True)
            startup.global_block.append_op(
                "fill_constant", {}, {"Out": [name]},
                {"shape": shape, "dtype": p.dtype, "value": 0.5})
        a = blk.create_var(name="a", dtype="float32")
        b = blk.create_var(name="b", dtype="float32")
        blk.append_op("matmul_v2", {"X": [x.name], "Y": ["wt"]},
                      {"Out": ["a"]}, {"trans_x": False, "trans_y": True})
        blk.append_op("mul", {"X": [x.name], "Y": ["w3"]}, {"Out": ["b"]},
                      {"x_num_col_dims": 1, "y_num_col_dims": 2})
        c = layers.fc(x, 5, param_attr=ParamAttr[which](
            initializer=Constant[which](0.25)))
    return main, startup, (a, b, c)


def test_transposed_and_flattened_weights_are_skipped_and_counted():
    pair = {}
    for which in PKG:
        pkg = PKG[which][0]
        main, startup, outs = _skip_program(which)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.framework.Scope()
        exe.run(startup, scope=scope)
        pair[which] = (main, outs, exe, scope)
    feed = {"x": np.random.RandomState(2).randn(3, 8).astype("f4")}
    n0 = {w: (PKG[w][4]("pass_weight_quant_ops"),
              PKG[w][4]("pass_weight_quant_skipped")) for w in PKG}
    _set_mode("int8")
    got = {}
    for w, (main, outs, exe, scope) in pair.items():
        got[w] = [np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=list(outs), scope=scope)]
    for w in PKG:
        assert PKG[w][4]("pass_weight_quant_ops") - n0[w][0] == 1
        assert PKG[w][4]("pass_weight_quant_skipped") - n0[w][1] == 2
    assert not pair["torch"][3].has_var("wt@WQ")
    for a, b in zip(got["torch"], got["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_fp8_carriers_reach_the_lowering_as_float8():
    """The carrier is declared int8 in the block (the IR has no float8
    type); the scope keeps float8_e4m3fn and the executor hands it on
    uncast, so the output follows the fp8 grid as the JAX package's
    does."""
    pair = _pair(_fc_program, seed=7)
    feed = {"x": np.random.RandomState(3).randn(4, 16).astype("f4")}
    _set_mode("fp8_e4m3")
    q = {w: _run(pair, w, feed) for w in PKG}
    main, h, _exe, scope = pair["torch"]
    rewritten = tpasses.apply_passes(main, fetch_names=(h.name,),
                                     feed_names=("x",), scope=scope)
    _set_mode("")
    carrier = scope.get_var("fc_0.w_0@WQ_FP8")
    assert carrier.dtype == torch.float8_e4m3fn
    assert rewritten.global_block.var("fc_0.w_0@WQ_FP8").dtype_str == "int8"
    assert {op.attr("mode") for op in rewritten.global_block.ops
            if op.type == "dequant_matmul"} == {"fp8_e4m3"}
    for ours, theirs in (("@WQ_FP8", "@WQ"), ("@WQ_FP8_SCALE", "@WQ_SCALE")):
        assert np.array_equal(_carrier_bits(scope, "fc_0.w_0" + ours),
                              _carrier_bits(pair["jax"][3],
                                            "fc_0.w_0" + theirs))
    np.testing.assert_allclose(q["torch"], q["jax"], rtol=0, atol=TOL)


def test_pass_cache_rekeys_on_the_flag():
    """Each value of FLAGS_weight_quant gets its own pass-cache entry, and
    each mode its own carriers: int8, fp8, off and int8 again in one scope
    give three rewrites (the last a cache hit) and the last int8 output
    equals the first.  (The JAX package names both modes' carriers
    ``@WQ``, so its cached int8 rewrite then reads the fp8 carriers and
    returns the fp8 output: ROADMAP Queue C.)"""
    pair = _pair(_fc_program, seed=8)
    feed = {"x": np.random.RandomState(4).randn(2, 16).astype("f4")}
    n0, h0 = tstat("pass_weight_quant_ops"), tstat("executor_pass_cache_hit")
    outs = {w: [] for w in PKG}
    for mode in ("int8", "fp8_e4m3", "", "int8"):
        _set_mode(mode)
        for w in PKG:
            outs[w].append(_run(pair, w, feed))
    _set_mode("")
    scope = pair["torch"][3]
    assert scope.get_var("fc_0.w_0@WQ").dtype == torch.int8
    assert scope.get_var("fc_0.w_0@WQ_FP8").dtype == torch.float8_e4m3fn
    assert tstat("pass_weight_quant_ops") - n0 == 4
    assert tstat("executor_pass_cache_hit") - h0 >= 1
    ours, theirs = outs["torch"], outs["jax"]
    assert np.array_equal(ours[3], ours[0])
    assert not np.array_equal(ours[0], ours[1])
    for a, b in zip(ours[:3], theirs[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert np.array_equal(theirs[3], theirs[1])


def test_pass_order_and_refusals():
    """The pass sits right after flash_attention_fuse, as in the JAX order
    restricted to the passes the port has; a tensor-parallel plan is
    refused, naming a later slice; a moe_ffn op is taken (its expert
    slots quantized in place, ``test_torch_moe_serving.py``), and one
    without stacked weights counts its two slots as skipped."""
    ours = [p.name for p in tpasses.default_pipeline().passes]
    from paddle_tpu.framework import passes as jpasses

    theirs = [p.name for p in jpasses.default_pipeline().passes
              if p.name in ours]
    assert ours == theirs == ["flash_attention_fuse",
                              "post_training_weight_quant",
                              "layer_scan",
                              "fuse_allreduce",
                              "redundant_cast_eliminate",
                              "dead_op_eliminate"]
    main, _h, _exe, scope = _pair(_fc_program, depth=1, seed=9)["torch"]
    ctx = tpasses.PassContext(scope=scope)
    main._tp_plan = object()
    with pytest.raises(NotImplementedError, match="later slice"):
        PostTrainingWeightQuantPass(mode="int8").apply(main, ctx)
    del main._tp_plan
    main.global_block.append_op("moe_ffn", {"X": ["x"]}, {"Out": ["y"]})
    skipped = tstat("pass_weight_quant_skipped")
    assert PostTrainingWeightQuantPass(mode="int8").apply(main, ctx)
    assert tstat("pass_weight_quant_skipped") - skipped == 2
    assert "mode" not in main.global_block.ops[-1].attrs
