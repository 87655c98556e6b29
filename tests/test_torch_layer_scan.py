"""PyTorch port: scan-over-layers (``framework/passes.py``
``LayerScanPass``, ``ops/layer_scan.py``) against the JAX package.

- The rewrite: a program built by the JAX package, parsed by the port
  from its ``__model__`` bytes, and the same program built by the port's
  own builders, rewritten by both passes into the same op list (the
  ``layer_scan`` / ``layer_index`` ops with their attrs and slots), the
  same template blocks and the same carriers and members: a 6-layer MLP
  with dropout and a 4-layer, hidden-32 BERT pretrain.
- Numbers: the scanned BERT pretrain for 3 steps from the JAX startup's
  values (dropout 0), within 1e-5 of the JAX package's scanned run
  (float32, the two packages' summation orders); with dropout 0.1 the
  port's scanned run equals its unrolled run bit for bit (the body
  launches the unrolled layer's ops in the same order and draws from the
  program's generator in the same order).
- A trimmed run: BERT's edge layers stay unrolled and read and update
  their carriers' slices; through the capture path (a recording
  stand-in for the CUDA graph) every step's state equals the unrolled
  eager run's, and the edge layer's update lands in its carrier.
- Non-isomorphic layers and shallow programs are left untouched, with
  their skip counters; the flag's default leaves every program as it is;
  an error inside the body names the inner op; ``remat_policy`` and
  ``unroll`` are recorded and change no number.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
import torch_layer_scan_models as M
from paddle_tpu.framework import passes as jpasses
from paddle_tpu.monitor import stat_get as jstat
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.framework.program import Program as TProgram
from paddle_tpu_torch.framework.scope import StackedParamRef, scope_from_numpy
from paddle_tpu_torch.monitor import stat_get, stat_reset

SKIP_REASONS = (
    "no_repeats", "stack_align", "rename_conflict", "input_classify",
    "output_classify", "shared_written", "outside_write",
    "family_mismatch", "tp_spec_mismatch", "ys_conflict", "var_missing",
)
JAX_TOL = 1e-5


@pytest.fixture(autouse=True)
def _flags():
    yield
    for p in (J, T):
        M.set_scan(p, False)


def _reset_counters():
    for k in ("pass_layer_scan_segments", "pass_layer_scan_layers",
              "pass_layer_scan_skipped"):
        stat_reset(k)
    for r in SKIP_REASONS:
        stat_reset("pass_layer_scan_skipped_" + r)


def _rewrite_both(build, fetch, feeds, from_bytes):
    """The JAX pass over the JAX program and the port's pass over the
    same program (parsed from the JAX bytes, or built by the port)."""
    jmain = build(J)[0]
    tmain = TProgram.parse_from_string(jmain.serialize_to_string()) \
        if from_bytes else build(T)[0]
    jout = jpasses.apply_passes(jmain, fetch_names=fetch, feed_names=feeds)
    tout = tpasses.apply_passes(tmain, fetch_names=fetch, feed_names=feeds)
    return jout, tout


def _stacks(program):
    return [(st["carrier"], tuple(st["members"]), tuple(st["shape"]))
            for st in program._layer_plan.stacks]


@pytest.mark.parametrize("model", ["mlp", "bert"])
@pytest.mark.parametrize("source", ["jax_bytes", "port_builder"])
def test_rewrite_equals_the_jax_pass(model, source):
    if model == "mlp":
        build, fetch = M.mlp, ("mean_0.tmp_0",)
        feeds = ("x", "y")
        for p in (J, T):
            M.set_scan(p, True)
    else:
        build = M.bert
        fetch = (M.bert(T)[2].name,)
        feeds = tuple(M.bert_feed())
        for p in (J, T):
            M.set_scan(p, True, min_layers=2)
    _reset_counters()
    jout, tout = _rewrite_both(build, fetch, feeds, source == "jax_bytes")
    assert stat_get("pass_layer_scan_segments") == \
        jstat("pass_layer_scan_segments") > 0
    assert stat_get("pass_layer_scan_layers") == \
        jstat("pass_layer_scan_layers")
    assert M.op_list(tout) == M.op_list(jout)
    scans = [op for op in tout.global_block.ops if op.type == "layer_scan"]
    assert scans
    for op in scans:
        blk = int(op.attr("layer_block"))
        assert M.op_list(tout, blk) == M.op_list(jout, blk)
    assert _stacks(tout) == _stacks(jout)


def _bert_runs(dropout, init, scan, steps=3, capture=False, monkeypatch=None):
    M.set_scan(T, scan, min_layers=2)
    main, _startup, loss = M.bert(T, dropout)
    scope = scope_from_numpy(init, "cpu")
    exe = T.Executor(T.CPUPlace())
    if capture:
        import test_torch_executor_graph as teg

        monkeypatch.setattr(texecutor, "StepGraph", teg._RecordedStep)
        exe._captures = True
    losses, _ = M.train(T, main, loss, scope,
                        [M.bert_feed(i) for i in range(steps)], exe)
    return losses, scope, exe, main


@pytest.fixture(scope="module")
def bert_init():
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # bit equality of CPU embedding gradients
    yield M.init_state(J, M.bert(J)[1])
    torch.set_num_threads(n)


def test_bert_scanned_within_1e5_of_the_jax_scanned_run(bert_init):
    M.set_scan(J, True, min_layers=2)
    jmain, _s, jloss = M.bert(J)
    jscope = J.framework.Scope()
    for n, v in bert_init.items():
        jscope.set_var(n, v)
    want, _ = M.train(J, jmain, jloss, jscope,
                      [M.bert_feed(i) for i in range(3)])
    assert jstat("pass_layer_scan_segments") > 0
    _reset_counters()
    got, scope, _exe, _m = _bert_runs(0.0, bert_init, True)
    assert stat_get("pass_layer_scan_segments") == \
        jstat("pass_layer_scan_segments")
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    for n, v in bert_init.items():
        if n.startswith(tpasses.LAYER_STACK_PREFIX):
            continue
        np.testing.assert_allclose(np.asarray(scope.get_var(n)),
                                   np.asarray(jscope.get_var(n)),
                                   rtol=0, atol=JAX_TOL, err_msg=n)


def test_bert_scanned_with_dropout_bit_equal_to_unrolled(bert_init):
    want, uscope, _e, _m = _bert_runs(0.1, bert_init, False)
    got, sscope, _e, _m = _bert_runs(0.1, bert_init, True)
    assert got == want
    for n in bert_init:
        assert np.array_equal(np.asarray(sscope.get_var(n)),
                              np.asarray(uscope.get_var(n))), n


def _edge_members(program, scope):
    """Members of a state carrier that an unrolled op writes (a trimmed
    run's edge layer)."""
    out = set()
    for op in program.global_block.ops:
        if op.type in ("layer_scan", "layer_index"):
            continue
        for n in op.output_arg_names():
            if scope.has_var(n) and isinstance(scope.get_var(n),
                                               StackedParamRef):
                out.add(n)
    return sorted(out)


def test_trimmed_run_edge_layer_updated_every_step(bert_init, monkeypatch):
    want, uscope, _e, _m = _bert_runs(0.1, bert_init, False, steps=1)
    got, sscope, exe, main = _bert_runs(0.1, bert_init, True, steps=1,
                                        capture=True,
                                        monkeypatch=monkeypatch)
    rewritten = exe._pass_cache[next(iter(exe._pass_cache))]
    edges = _edge_members(rewritten, sscope)
    assert edges, "BERT's rewrite keeps no edge layer unrolled"
    carriers = {n: sscope.get_var(sscope.get_var(n).stack_name)
                for n in edges}
    uexe = T.Executor(T.CPUPlace())
    umain = M.bert(T, 0.1)[0]
    for step in range(1, 4):
        before = {n: np.asarray(sscope.get_var(n)).copy() for n in edges}
        g, _ = M.train(T, main, M.bert(T, 0.1)[2], sscope,
                       [M.bert_feed(step)], exe)
        M.set_scan(T, False)
        w, _ = M.train(T, umain, M.bert(T, 0.1)[2], uscope,
                       [M.bert_feed(step)], uexe)
        M.set_scan(T, True, min_layers=2)
        assert g == w
        for n in edges:
            ref = sscope.get_var(n)
            assert isinstance(ref, StackedParamRef)
            # the view reads the carrier the graph holds as its buffer
            assert sscope.get_var(ref.stack_name) is carriers[n]
            now = np.asarray(ref)
            assert not np.array_equal(now, before[n]), n
            assert np.array_equal(now, np.asarray(uscope.get_var(n))), n
    # every step after the second was a replay of the captured step
    assert [e.graph is not None for e in exe._cache.values()] == [True]


def test_non_isomorphic_layers_skipped():
    M.set_scan(T, True)
    _reset_counters()
    main, startup, loss = M.mlp(T, n_layers=8, dropout=0.0,
                                widths=[16 if i % 2 else 24
                                        for i in range(8)])
    scope = T.framework.Scope()
    exe = T.Executor(T.CPUPlace())
    exe.run(startup, scope=scope)
    M.train(T, main, loss, scope, [M.mlp_data()], exe)
    assert not stat_get("pass_layer_scan_segments")
    assert not any(n.startswith(tpasses.LAYER_STACK_PREFIX)
                   for n in scope.local_var_names())


def test_shallow_program_untouched():
    M.set_scan(T, True)
    _reset_counters()
    main, startup, loss = M.mlp(T, n_layers=2)
    scope = T.framework.Scope()
    exe = T.Executor(T.CPUPlace())
    exe.run(startup, scope=scope)
    losses, _ = M.train(T, main, loss, scope, [M.mlp_data()], exe)
    assert np.isfinite(losses).all()
    assert not stat_get("pass_layer_scan_segments")
    assert stat_get("pass_layer_scan_skipped") >= 1
    assert stat_get("pass_layer_scan_skipped_no_repeats") >= 1


def test_flag_off_is_default_and_untouched():
    assert T.get_flags(["FLAGS_layer_scan"])["FLAGS_layer_scan"] is False
    _reset_counters()
    main = M.mlp(T)[0]
    out = tpasses.apply_passes(main, fetch_names=("mean_0.tmp_0",),
                               feed_names=("x", "y"))
    assert not any(op.type == "layer_scan" for op in out.global_block.ops)
    assert not stat_get("pass_layer_scan_segments")


def test_mlp_scanned_bit_equal_and_user_program_untouched():
    data = M.mlp_data()

    def run(scan):
        M.set_scan(T, scan)
        main, startup, loss = M.mlp(T)
        scope = T.framework.Scope()
        exe = T.Executor(T.CPUPlace())
        exe.run(startup, scope=scope)
        losses, _ = M.train(T, main, loss, scope, [data] * 4, exe)
        return losses, scope, main

    want, uscope, _ = run(False)
    got, sscope, main = run(True)
    assert got == want
    assert not any(op.type == "layer_scan" for op in main.global_block.ops)
    for n in uscope.local_var_names():
        if "blk" in n:
            assert np.array_equal(np.asarray(uscope.get_var(n)),
                                  np.asarray(sscope.get_var(n))), n
    assert any(isinstance(sscope.get_var(n), StackedParamRef)
               for n in sscope.local_var_names())


def test_body_error_names_the_inner_op():
    M.set_scan(T, True)
    main, startup, loss = M.mlp(T, dropout=0.0)
    rewritten = tpasses.apply_passes(main, fetch_names=(loss.name,),
                                     feed_names=("x", "y"))
    scan = next(op for op in rewritten.global_block.ops
                if op.type == "layer_scan")
    body = rewritten.blocks[int(scan.attr("layer_block"))]
    victim = body.ops[0]
    victim.type = "op_without_a_lowering"
    scope = T.framework.Scope()
    exe = T.Executor(T.CPUPlace())
    exe.run(startup, scope=scope)
    rewritten._layer_plan.ensure_stacked(scope)
    with pytest.raises(NotImplementedError,
                       match="'op_without_a_lowering' inside layer_scan "
                             r"\(built at"):
        exe._run_block(rewritten, texecutor._feed_tensors(
            rewritten.global_block, M.mlp_data(), exe.device),
            (loss.name,), scope)


@pytest.mark.parametrize("knob", [{"policy": "dots_saveable"},
                                  {"policy": "nothing_saveable"},
                                  {"unroll": 2}])
def test_policy_and_unroll_recorded_numbers_unchanged(knob):
    data = M.mlp_data()

    def run(**kw):
        M.set_scan(T, True, **kw)
        main, startup, loss = M.mlp(T)
        scope = T.framework.Scope()
        exe = T.Executor(T.CPUPlace())
        exe.run(startup, scope=scope)
        losses, _ = M.train(T, main, loss, scope, [data] * 3, exe)
        prog = next(iter(exe._pass_cache.values()))
        return losses, [op for op in prog.global_block.ops
                        if op.type == "layer_scan"]

    base, _ = run()
    got, scans = run(**knob)
    assert got == base and scans
    for op in scans:
        if "policy" in knob:
            assert op.attr("remat_policy") == knob["policy"]
        else:
            assert op.attr("unroll") == knob["unroll"]
