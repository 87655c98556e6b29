"""PyTorch port: MoE serving (``TransformerLM(moe_experts=...)`` through
``DecodeEngine``) and MoE weight quantization, against the JAX package on
the CPU.

The JAX package's MoE weights (numpy, from one PRNG key) are carried into
the port with ``weights_from_numpy`` and both engines serve the same
prompts (E = 4 experts, top-2, dropless): per-step logits within 1e-4
absolute and greedy tokens equal, as ``tests/test_torch_decode.py`` holds
the dense model (float32 products summed in other orders over two
layers; the routing is the same choice of experts, since the router's
top-2 margins at these widths are far above 1e-6).  The port's streamed
logits are held against its own ``recompute_logits`` within 1e-5 (other
row counts).

``quantize_moe_weights`` and the ``PostTrainingWeightQuantPass``
``moe_ffn`` branch give carriers and scales BIT-equal to the JAX
package's (per-expert abs-max, a division by a tensor, round half to
even / a round-to-nearest-even float8 cast: exact steps); the quantized
engine's logits are held to the JAX quantized engine's within 1e-4.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode as jdec
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                      TransformerLM, quantize_moe_weights,
                                      shard_moe_weights, weights_from_numpy)
from torch_fleet_parity import build_both

VOCAB = 61
JAX_TOL = 1e-4
SELF_TOL = 1e-5
E, K = 4, 2
CFG = dict(slots=3, max_seq_len=64, page_size=8, max_new_tokens=8)
DIMS = dict(d_model=32, num_layers=2, num_heads=2, max_seq_len=64,
            moe_experts=E, moe_top_k=K)
WAVES = {"plain": ({}, [[1, 2, 3, 4, 5], [9, 8, 7], [11] * 17]),
         "chunked": ({"prefill_chunk_pages": 1},
                     [[3] * 20, [5, 6, 7, 8, 9, 10, 11, 12, 13], [2]])}


@pytest.fixture(scope="module")
def jax_model():
    import jax

    model = jdec.TransformerLM(vocab_size=VOCAB, **DIMS)
    weights = model.init_weights(jax.random.PRNGKey(3))
    return model, weights, jax.tree_util.tree_map(np.asarray, weights)


def _port(np_weights):
    model = TransformerLM(VOCAB, device="cpu", **DIMS)
    return model.load_weights(weights_from_numpy(np_weights, "cpu"))


def _serve(engine, prompts):
    engine.start()
    try:
        reqs = [engine.submit(p, record_logits=True, max_new_tokens=6)
                for p in prompts]
        for r in reqs:
            r.result(timeout=120)
    finally:
        engine.stop()
    return reqs


def _assert_same(treqs, jreqs):
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated
        assert len(t.logits_trace) == len(j.logits_trace) == 6
        for a, b in zip(t.logits_trace, j.logits_trace):
            np.testing.assert_allclose(a, b, rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("path", sorted(WAVES))
def test_moe_engine_matches_jax_engine(jax_model, path):
    jm, jw, npw = jax_model
    over, prompts = WAVES[path]
    cfg = dict(CFG, **over)
    jreqs = _serve(jdec.DecodeEngine(jm, jw, jdec.DecodeConfig(**cfg)),
                   prompts)
    model = _port(npw)
    assert sorted(dict(model.layers[0].named_parameters())) == \
        sorted(npw["layers"][0])
    eng = DecodeEngine(model, None, DecodeConfig(**cfg))
    treqs = _serve(eng, prompts)
    _assert_same(treqs, jreqs)
    for r in treqs:
        for i, got in enumerate(r.logits_trace):
            want = eng.recompute_logits(r.prompt + r.generated[:i])
            np.testing.assert_allclose(got, want, rtol=0, atol=SELF_TOL)


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_quantize_moe_weights_bit_equal_to_jax(jax_model, mode):
    _jm, jw, npw = jax_model
    theirs = jdec.quantize_moe_weights(jw, mode)
    n0 = stat_get("serving_moe_weights_quantized")
    ours = quantize_moe_weights(weights_from_numpy(npw, "cpu"), mode)
    assert stat_get("serving_moe_weights_quantized") - n0 == 2 * 2
    for lo, lt in zip(ours["layers"], theirs["layers"]):
        assert sorted(lo) == sorted(lt)
        for nm in ("moe_w1_q", "moe_w1_scale", "moe_w2_q", "moe_w2_scale"):
            a, b = to_numpy(lo[nm]), np.asarray(lt[nm])
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), nm
    assert "moe_w1" in weights_from_numpy(npw, "cpu")["layers"][0]
    with pytest.raises(ValueError, match="no stacked expert"):
        quantize_moe_weights({"layers": [{"w1": torch.zeros(2, 2)}]})


def test_int8_engine_matches_jax_int8_engine(jax_model):
    """The quantized layout loads into the model (carriers + scales in
    place of the float stacks), serves as the JAX quantized engine does,
    and the float layout loads back."""
    import jax

    jm, jw, npw = jax_model
    jq = jdec.quantize_moe_weights(jw, "int8")
    prompts = WAVES["plain"][1]
    jreqs = _serve(jdec.DecodeEngine(jm, jq, jdec.DecodeConfig(**CFG)),
                   prompts)
    model = _port(npw)
    qw = weights_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    treqs = _serve(DecodeEngine(model, qw, DecodeConfig(**CFG)), prompts)
    assert model.layers[0].moe_quantized
    assert model.layers[0].moe_w1_q.dtype == torch.int8
    _assert_same(treqs, jreqs)
    model.load_weights(weights_from_numpy(npw, "cpu"))
    assert not model.layers[1].moe_quantized and \
        model.layers[1].moe_w2.dtype == torch.float32


def test_expert_parallel_raises_naming_item_8():
    with pytest.raises(NotImplementedError, match="item 8"):
        TransformerLM(VOCAB, device="cpu", moe_mesh=object(), **DIMS)
    with pytest.raises(NotImplementedError, match="item 8"):
        shard_moe_weights({"layers": []}, object())
    with pytest.raises(ValueError, match="exceeds"):
        TransformerLM(VOCAB, device="cpu", **dict(DIMS, moe_top_k=5))


def _moe_program(p):
    layers = p.layers
    main, startup = p.framework.Program(), p.framework.Program()
    main.random_seed = 4
    with p.framework.program_guard(main, startup):
        x = layers.data("x", [16])
        h, _aux, _load = layers.moe_ffn(x, num_experts=E, ffn_dim=24,
                                        top_k=K, capacity_factor=2.0,
                                        name="moe0")
        out = layers.fc(h, 3, name="head")
    return main, startup, [out]


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_weight_quant_pass_moe_branch_bit_equal_to_jax(mode):
    """The pass quantizes the moe_ffn op's W1/W2 in place (carriers and
    per-expert scales on W1Scale/W2Scale, the op's ``mode`` set) with the
    JAX package's carriers, bit for bit, and the rewritten program runs
    within 1e-4 of the JAX one."""
    import paddle_tpu as J
    import paddle_tpu_torch as T
    from paddle_tpu_torch.framework.scope import scope_from_numpy

    (jm, js, _), (tm, ts, tf) = build_both(_moe_program)
    jexe, jscope = J.Executor(J.CPUPlace()), J.framework.Scope()
    jexe.run(js, scope=jscope)
    init = {v.name: np.asarray(jscope.get_var(v.name))
            for v in js.global_block.vars.values() if v.persistable}
    tscope = scope_from_numpy(init, device="cpu")
    x = np.random.RandomState(0).randn(10, 16).astype("f4")
    res = {}
    for pkg, prog, exe, scope in (
            (J, jm, jexe, jscope),
            (T, tm, T.Executor(T.CPUPlace()), tscope)):
        slim = import_module(pkg.__name__ + ".slim")
        passes = import_module(pkg.__name__ + ".framework.passes")
        qprog = prog.clone()
        assert slim.PostTrainingWeightQuantPass(mode=mode).apply(
            qprog, passes.PassContext(scope=scope))
        op = next(o for o in qprog.global_block.ops if o.type == "moe_ffn")
        assert op.attr("mode") == mode
        out = exe.run(qprog, feed={"x": x}, fetch_list=[tf[0].name],
                      scope=scope)[0]
        res[pkg] = (op, np.asarray(out), scope)
    (jop, jout, jsc), (top, tout, tsc) = res[J], res[T]
    for slot in ("W1", "W1Scale", "W2", "W2Scale"):
        a = to_numpy(tsc.get_var(top.input(slot)[0]))
        b = np.asarray(jsc.get_var(jop.input(slot)[0]))
        assert a.dtype == b.dtype and a.shape == b.shape, slot
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), slot
    assert top.input("W1Scale")[0].endswith(
        "@WQ_SCALE" if mode == "int8" else "@WQ_FP8_SCALE")
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-4)
