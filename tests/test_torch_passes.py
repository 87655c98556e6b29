"""PyTorch port: the program-IR pass pipeline (``framework/passes.py``),
held structurally against the JAX package's.

The same program is built in both packages (the attention train program
of ``tests/test_flash_attention.py``, a 2-layer BERT with the unfused
attention chain, the fused BERT of slice 2, and a small program with
redundant casts and dead ops), ``apply_passes`` runs in both, and the op
lists are compared one for one: type, input and output names by slot, and
the attrs the rewrite sets.  Every refusal of ``FlashAttentionPass`` is
pinned in both packages: dropout on the probabilities, a fetched
intermediate, a learnable mask, a partial grad chain, and BERT under
bfloat16 AMP (AMP casts the mask, and the cast's gradient reads to the
pass as a learnable mask: 0 rewrites in the reference, so 0 in the port).
No numbers are compared here, so there is no tolerance.
"""
import math

import pytest

import paddle_tpu as jpkg
from paddle_tpu import layers as jlayers
from paddle_tpu.amp.static_amp import decorate as jdecorate
from paddle_tpu.framework import passes as jpasses
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.initializer import NormalInitializer as JNormal
from paddle_tpu.optimizer import MomentumOptimizer as JMomentum
from paddle_tpu.param_attr import ParamAttr as JParamAttr
from paddle_tpu.text import bert_base_pretrain_program as jbert
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.amp import decorate as tdecorate
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.executor import _prune_ops
from paddle_tpu_torch.initializer import NormalInitializer as TNormal
from paddle_tpu_torch.observe import tracer as ttracer
from paddle_tpu_torch.optimizer import MomentumOptimizer as TMomentum
from paddle_tpu_torch.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.text import bert_base_pretrain_program as tbert

S, HEADS, D = 16, 2, 8
HID = HEADS * D
PKG = {
    "jax": dict(pkg=jpkg, layers=jlayers, program=jprogram, unique=junique,
                passes=jpasses, normal=JNormal, momentum=JMomentum,
                attr=JParamAttr, bert=jbert, decorate=jdecorate),
    "torch": dict(pkg=tpkg, layers=tlayers, program=tprogram, unique=tunique,
                  passes=tpasses, normal=TNormal, momentum=TMomentum,
                  attr=TParamAttr, bert=tbert, decorate=tdecorate),
}
BERT_CFG = dict(batch_size=2, seq_len=128, vocab_size=64, hidden=128,
                n_layers=2, n_heads=2, ffn_size=256, lr=1e-3,
                max_preds_per_seq=3)


@pytest.fixture(autouse=True)
def _flag_reset():
    yield
    for which in PKG.values():
        which["pkg"].set_flags({"FLAGS_flash_attention": "auto",
                                "FLAGS_fuse_passes": True})


def _set_flags(flags):
    for which in PKG.values():
        which["pkg"].set_flags(flags)


def _attn_train_program(which, with_mask=True, dropout=0.0,
                        learnable_mask=False):
    """``tests/test_flash_attention.py:_attn_train_program`` in either
    package: qkv projections -> matmul(alpha) -> [mask add] -> softmax ->
    matmul -> out projection -> mse, momentum backward."""
    p = PKG[which]
    layers = p["layers"]
    main, startup = p["program"].Program(), p["program"].Program()
    main.random_seed = 11
    with p["unique"].guard(), p["program"].program_guard(main, startup):
        x = layers.data("x", [S, HID])
        y = layers.data("y", [S, HID])

        def proj(name):
            t = layers.fc(x, HID, num_flatten_dims=2, name=name,
                          param_attr=p["attr"](
                              initializer=p["normal"](0.0, 0.05)))
            t = layers.reshape(t, [0, S, HEADS, D])
            return layers.transpose(t, [0, 2, 1, 3])

        q, k, v = proj("attn_q"), proj("attn_k"), proj("attn_v")
        scores = layers.matmul(q, k, transpose_y=True,
                               alpha=1.0 / math.sqrt(D))
        mask = None
        if learnable_mask:
            m = layers.fc(x, S, num_flatten_dims=2, name="attn_mask")
            mask = layers.reshape(m, [0, 1, S, S])
        elif with_mask:
            mask = layers.data("mask", [1, 1, S])
        if mask is not None:
            scores = layers.elementwise_add(scores, mask)
        probs = layers.softmax(scores)
        if dropout:
            probs = layers.dropout(probs, dropout)
        ctxv = layers.matmul(probs, v)
        ctxv = layers.transpose(ctxv, [0, 2, 1, 3])
        ctxv = layers.reshape(ctxv, [0, S, HID])
        out = layers.fc(ctxv, HID, num_flatten_dims=2, name="attn_out",
                        param_attr=p["attr"](
                            initializer=p["normal"](0.0, 0.05)))
        loss = layers.mean(layers.square_error_cost(out, y))
        p["momentum"](0.05, 0.9).minimize(loss)
    return main, loss.name, probs.name


def _bert(which, fused, dropout=0.0, amp=False):
    p = PKG[which]
    with p["unique"].guard():
        main, startup, _feeds, loss, opt = p["bert"](
            dropout_prob=dropout, use_fused_attention=fused, **BERT_CFG)
        main.random_seed = 1
        with p["program"].program_guard(main, startup):
            (p["decorate"](opt, use_bf16=True) if amp else opt).minimize(loss)
    return main, loss.name


def _op_list(program):
    return [(op.type,
             {s: list(ns) for s, ns in sorted(op.inputs.items())},
             {s: list(ns) for s, ns in sorted(op.outputs.items())},
             {a: op.attr(a) for a in ("scale", "causal", "__fwd_type__",
                                      "__fwd_out_slots__", "out_dtype")
              if op.has_attr(a) and op.type in (
                  "flash_attention", "flash_attention_grad", "cast")})
            for op in program.global_block.ops]


def _apply(which, main, fetch_names, feed_names=()):
    return PKG[which]["passes"].apply_passes(
        main, fetch_names=tuple(fetch_names), feed_names=tuple(feed_names))


def _both(build, fetch=lambda names: names[:1], **kw):
    """Build in both packages, run ``apply_passes`` in both; returns
    {package: (program as built, program after the passes)}."""
    out = {}
    for which in PKG:
        main, *names = build(which, **kw)
        out[which] = (main, _apply(which, main, fetch(names)))
    # the two packages built the same program to begin with
    assert _op_list(out["torch"][0]) == _op_list(out["jax"][0])
    return out


def _types(program):
    return [op.type for op in program.global_block.ops]


# -- accepted chains: op lists equal to the JAX package's -------------------


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_attention_program_rewrite_equals_jax(with_mask):
    _set_flags({"FLAGS_flash_attention": "always"})
    tmonitor.stat_reset("pass_flash_attention_fused")
    tmonitor.stat_reset("pass_flash_attention_grad_fused")
    got = _both(_attn_train_program, with_mask=with_mask)
    (before, after), (_jb, jafter) = got["torch"], got["jax"]
    assert after is not before            # copy on write
    assert "softmax" in _types(before)    # the caller's program is as built
    assert _op_list(after) == _op_list(jafter)
    types = _types(after)
    assert types.count("flash_attention") == 1
    assert types.count("flash_attention_grad") == 1
    for gone in ("softmax", "softmax_grad", "matmul", "matmul_grad"):
        assert gone not in types
    fop = next(op for op in after.global_block.ops
               if op.type == "flash_attention")
    assert ("Mask" in fop.inputs) == with_mask
    assert abs(float(fop.attr("scale")) - 1.0 / math.sqrt(D)) < 1e-12
    assert tmonitor.stat_get("pass_flash_attention_fused") == 1
    assert tmonitor.stat_get("pass_flash_attention_grad_fused") == 1


def test_unfused_bert_rewrite_equals_jax():
    _set_flags({"FLAGS_flash_attention": "always"})
    got = _both(_bert, fused=False)
    (before, after), (_jb, jafter) = got["torch"], got["jax"]
    assert _op_list(after) == _op_list(jafter)
    assert len(before.global_block.ops) == 232
    assert len(after.global_block.ops) == 220
    types = _types(after)
    assert types.count("flash_attention") == 2
    assert types.count("flash_attention_grad") == 2
    # a pass-built op fingerprints and serializes like a built one
    assert after.fingerprint() != before.fingerprint()
    assert after.fingerprint() == after.clone().fingerprint()
    again = tprogram.Program.parse_from_string(after.serialize_to_string())
    assert _op_list(again) == _op_list(after)


def test_forward_only_chain_is_rewritten_without_a_grad_op():
    _set_flags({"FLAGS_flash_attention": "always"})
    after = {}
    for which, p in PKG.items():
        main, loss, _probs = _attn_train_program(which)
        infer = main.clone(for_test=True)
        keep = [op for op in infer.global_block.ops
                if not op.type.endswith("_grad")
                and op.type not in ("momentum", "fill_constant")]
        infer.global_block.ops[:] = keep
        infer._bump()
        after[which] = _apply(which, infer, [loss])
    assert _op_list(after["torch"]) == _op_list(after["jax"])
    assert _types(after["torch"]).count("flash_attention") == 1
    assert "flash_attention_grad" not in _types(after["torch"])


# -- refusals ---------------------------------------------------------------


def _assert_refused(got):
    for which, (_before, after) in got.items():
        assert "flash_attention" not in _types(after), which
        assert "softmax" in _types(after), which
    assert _op_list(got["torch"][1]) == _op_list(got["jax"][1])


def test_refuses_dropout_on_probs():
    _set_flags({"FLAGS_flash_attention": "always"})
    _assert_refused(_both(_attn_train_program, dropout=0.3))


def test_refuses_fetched_intermediate():
    _set_flags({"FLAGS_flash_attention": "always"})
    _assert_refused(_both(_attn_train_program, fetch=lambda names: names))


def test_refuses_learnable_mask():
    _set_flags({"FLAGS_flash_attention": "always"})
    _assert_refused(_both(_attn_train_program, learnable_mask=True))


def test_refuses_partial_grad_chain():
    """A backward missing one of its four grad ops is left alone, forward
    and all: fusing half a backward would recompute the other half
    wrong."""
    _set_flags({"FLAGS_flash_attention": "always"})

    def build(which):
        main, loss, probs = _attn_train_program(which)
        ops = main.global_block.ops
        ops[:] = [op for op in ops if op.type != "softmax_grad"]
        main._bump()
        return main, loss, probs

    _assert_refused(_both(build))


def test_refuses_bert_with_dropout():
    _set_flags({"FLAGS_flash_attention": "always"})
    got = _both(_bert, fused=False, dropout=0.1)
    _assert_refused(got)
    assert len(got["torch"][1].global_block.ops) == 246


def test_refuses_bert_under_bfloat16_amp():
    """A finding about the reference, mirrored: AMP's gray list casts the
    mask (``input_mask.cast_0``), the add's gradient then carries a
    ``Y@GRAD`` for the cast, and the pass reads that as a learnable mask.
    312 ops stay 312 in both packages."""
    _set_flags({"FLAGS_flash_attention": "always"})
    got = _both(_bert, fused=False, amp=True)
    _assert_refused(got)
    before, after = got["torch"]
    assert len(before.global_block.ops) == 312
    assert len(after.global_block.ops) == 312
    adds = [op for op in before.global_block.ops
            if op.type == "elementwise_add_grad"
            and any("input_mask.cast" in n
                    for n in op.outputs.get("Y@GRAD", []))]
    assert len(adds) == 2


# -- flag gating ------------------------------------------------------------


def test_flag_gating():
    """'never' and 'auto' without a CUDA device never rewrite (CPU
    numerics are untouched by default); 'always' does."""
    main, loss, _ = _attn_train_program("torch")
    p = tpasses.FlashAttentionPass()
    ctx = tpasses.PassContext(fetch_names=(loss,))
    tpkg.set_flags({"FLAGS_flash_attention": "never"})
    assert not p.should_apply(main, ctx)
    assert _apply("torch", main, [loss]) is main
    tpkg.set_flags({"FLAGS_flash_attention": "auto"})
    assert not p.should_apply(main, ctx)      # this host has no card
    tpkg.set_flags({"FLAGS_flash_attention": "always"})
    assert p.should_apply(main, ctx)


def test_executor_gates_on_fuse_passes_and_caches():
    """``Executor._apply_graph_passes``: FLAGS_fuse_passes=0 hands the
    program back as built; a second call with the same key is a cache
    hit; flipping FLAGS_flash_attention re-keys."""
    main, loss, _ = _attn_train_program("torch")
    exe = tpkg.Executor(tpkg.CPUPlace())
    scope = tpkg.framework.Scope()
    args = (main, (loss,), {"x": None, "y": None, "mask": None}, scope)
    tpkg.set_flags({"FLAGS_flash_attention": "always",
                    "FLAGS_fuse_passes": False})
    assert exe._apply_graph_passes(*args) is main
    tpkg.set_flags({"FLAGS_fuse_passes": True})
    tpkg.set_flags({"FLAGS_enable_tracer": True})
    ttracer.clear()
    try:
        tmonitor.stat_reset("executor_pass_cache_hit")
        first = exe._apply_graph_passes(*args)
        spans = [sp.name for sp in ttracer.snapshot()]
    finally:
        tpkg.set_flags({"FLAGS_enable_tracer": False})
    assert "flash_attention" in _types(first) and first is not main
    assert "executor/pass_pipeline" in spans
    assert "pass/flash_attention_fuse" in spans
    assert exe._apply_graph_passes(*args) is first
    assert tmonitor.stat_get("executor_pass_cache_hit") == 1
    tpkg.set_flags({"FLAGS_flash_attention": "never"})
    assert exe._apply_graph_passes(*args) is main
    assert tmonitor.stat_get("executor_pass_cache_hit") == 1
    exe.close()
    assert not exe._pass_cache


# -- the registry and the pipeline -------------------------------------------


def test_registry_order_follows_the_jax_package():
    ours = list(tpasses.PASS_REGISTRY)
    assert ours == ["flash_attention_fuse", "redundant_cast_eliminate",
                    "dead_op_eliminate"]
    jpasses.default_pipeline()      # loads the passes registered elsewhere
    theirs = [n for n in jpasses.PASS_REGISTRY if n in ours]
    assert theirs == ours
    assert tpasses.default_pipeline().config_key() == tuple(ours)


def test_register_pass_before_and_duplicates():
    class Probe(tpasses.Pass):
        name = "probe_pass"

        def apply(self, program, ctx):
            return False

    saved = dict(tpasses.PASS_REGISTRY)
    try:
        tpasses.register_pass(Probe, before="dead_op_eliminate")
        assert list(tpasses.PASS_REGISTRY)[-2:] == ["probe_pass",
                                                    "dead_op_eliminate"]
        assert "probe_pass" in tpasses.default_pipeline().config_key()
        with pytest.raises(KeyError, match="already registered"):
            tpasses.register_pass(Probe)
        with pytest.raises(KeyError, match="no such"):
            tpasses.register_pass(type("P2", (Probe,), {"name": "p2"}),
                                  before="missing")
    finally:
        tpasses.PASS_REGISTRY.clear()
        tpasses.PASS_REGISTRY.update(saved)
        tpasses._default_pipeline = None


# -- cast elimination and dead-op elimination --------------------------------


def _cast_program(which):
    """fp32 -> bf16 -> bf16 (redundant) -> assign -> bf16 (redundant),
    an in-place no-op cast, and a dead branch."""
    p = PKG[which]
    layers = p["layers"]
    main, startup = p["program"].Program(), p["program"].Program()
    with p["unique"].guard(), p["program"].program_guard(main, startup):
        x = layers.data("x", [4])
        a = layers.cast(x, "bfloat16")
        b = layers.cast(a, "bfloat16")
        c = layers.assign(b)
        d = layers.cast(c, "bfloat16")
        main.global_block.append_op(
            "cast", {"X": [d]}, {"Out": [d]},
            {"in_dtype": 22, "out_dtype": main.global_block.ops[-1]
             .attr("out_dtype")})
        out = layers.cast(d, "float32")
        layers.scale(layers.cast(x, "float32"), 2.0)    # dead: feeds nothing
    return main, out.name


def test_cast_elimination_and_dce_equal_jax():
    tmonitor.stat_reset("pass_casts_removed")
    tmonitor.stat_reset("pass_dead_ops_removed")
    got = _both(_cast_program)
    (before, after), (_jb, jafter) = got["torch"], got["jax"]
    assert _op_list(after) == _op_list(jafter)
    assert _types(before) == ["cast", "cast", "assign", "cast", "cast",
                              "cast", "cast", "scale"]
    assert _types(after) == ["cast", "assign", "assign", "assign", "cast"]
    assert tmonitor.stat_get("pass_casts_removed") == 3
    assert tmonitor.stat_get("pass_dead_ops_removed") == 2


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16_amp"])
def test_fused_bert_after_the_passes_equals_jax(amp):
    """Slice 2's program behind the pipeline: whatever the cast and
    dead-op passes do to it, they do the same in both packages."""
    got = _both(_bert, fused=True, amp=amp)
    assert _op_list(got["torch"][1]) == _op_list(got["jax"][1])
    assert "flash_attention" not in _types(got["torch"][1])


def test_prune_ops_keeps_side_effects_and_refuses_nothing_silently():
    main, out = _cast_program("torch")
    keep = _prune_ops(main, [out])
    assert "scale" not in [op.type for op in keep]
    main.global_block.append_op("print", {"In": ["x"]}, {}, {})
    kinds = [op.type for op in _prune_ops(main, [out],
                                          keep_side_effect_ops=True)]
    assert kinds[-1] == "print" and "scale" not in kinds
    assert "print" not in [op.type for op in _prune_ops(main, [out])]
    # an op that owns a sub-block reads more than its slots show: the
    # port has no control flow yet and raises rather than mis-prune
    main.global_block.append_op("while", {"X": ["x"]}, {"Out": ["w"]},
                                {"sub_block": 1})
    with pytest.raises(NotImplementedError, match="control flow"):
        _prune_ops(main, [out])
