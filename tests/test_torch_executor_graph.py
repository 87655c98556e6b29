"""PyTorch port: the executor's compiled step (``framework/executor.py``,
``framework/graphs.py``), held to the JAX package's executor contracts.

On the CPU no graph is captured: an entry is the state analysis and the
free plan.  These tests hold the cache, the plan and the contracts of
``warmup``, ``run_persistent`` and the capture decision against the JAX
package with numpy inputs made from a seed, and run the executor's
capture path (static buffers, state written back in place, rebinding by
identity, the RNG generator) with a stand-in for ``StepGraph`` whose
replay runs the recorded step: what a replay computes is what the step
computes.  ``chip_smoke.py`` runs the real graphs on the card.

Tolerances: the tiny BERT step against the JAX executor, 1e-4 on a loss
of about 4 and on the parameters (``test_torch_bert.py``'s float32
bound: the same arithmetic in other summation orders); the port against
itself: captured and eager exactly equal, and frees on and off too but
for the BERT embedding tables' update (``SELF_TOL``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpkg
from paddle_tpu import inference as jinference
from paddle_tpu import layers as jlayers
from paddle_tpu.fluid import io as jio
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework import scope as jscope
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.monitor import stat_get as jstat_get
from paddle_tpu.monitor import stat_reset as jstat_reset
from paddle_tpu.optimizer import SGDOptimizer as JSGD
from paddle_tpu.text import bert_base_pretrain_program as jbert
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import observe as tobserve
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework import scope as tscope
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import scope_from_numpy
from paddle_tpu_torch.monitor import stat_get as tstat_get
from paddle_tpu_torch.monitor import stat_reset as tstat_reset
from paddle_tpu_torch.optimizer import MomentumOptimizer as TMomentum
from paddle_tpu_torch.optimizer import SGDOptimizer as TSGD
from paddle_tpu_torch.text import bert_base_pretrain_program as tbert

PKG = {"jax": dict(pkg=jpkg, layers=jlayers, program=jprogram,
                   unique=junique, io=jio, inference=jinference,
                   scope=jscope, stat_get=jstat_get, stat_reset=jstat_reset,
                   sgd=JSGD),
       "torch": dict(pkg=tpkg, layers=tlayers, program=tprogram,
                     unique=tunique, io=tio, inference=tinference,
                     scope=tscope, stat_get=tstat_get,
                     stat_reset=tstat_reset, sgd=TSGD)}
BOTH = pytest.mark.parametrize("which", ["jax", "torch"])
F32_TOL = 1e-4
# The port's embedding gradient scatters rows in a thread-dependent order
# on the CPU: two runs of one BERT step part by about 1e-8.
SELF_TOL = 1e-6


def _bytes(v):
    return np.asarray(tscope.to_numpy(v) if isinstance(v, torch.Tensor)
                      else v)


def _saved_model(which, d):
    """The serving tests' padding-invariant model (``test_serving.py``),
    saved by ``which``'s own ``fluid.io``."""
    p = PKG[which]
    main, startup = p["program"].Program(), p["program"].Program()
    main.random_seed = 7
    with p["unique"].guard(), p["program"].program_guard(main, startup):
        x = p["layers"].data("x", [-1, 4])
        h = p["layers"].fc(x, 8, num_flatten_dims=2, act="relu",
                           bias_attr=False)
        out = p["layers"].reduce_sum(h, dim=1)
    sc = p["pkg"].framework.Scope()
    exe = p["pkg"].Executor(p["pkg"].CPUPlace())
    exe.run(startup, scope=sc)
    old = p["scope"]._switch_scope(sc)
    try:
        p["io"].save_inference_model(d, ["x"], [out], exe, main)
    finally:
        p["scope"]._switch_scope(old)


def _predictor(which, d):
    cfg = PKG[which]["inference"].Config(d)
    if which == "torch":
        cfg.disable_gpu()
    return PKG[which]["inference"].create_predictor(cfg)


@BOTH
def test_warmup_counts_and_is_state_neutral(which, tmp_path):
    """4 fresh entries for the 4 specs, then 0; the scope byte-equal
    after; a warmed shape's run is a cache hit, not a compile."""
    p = PKG[which]
    _saved_model(which, str(tmp_path))
    pred = _predictor(which, str(tmp_path))
    exe, scope, prog = pred._exe, pred._scope, pred._program
    before = {n: _bytes(scope.get_var(n)).copy()
              for n in scope.local_var_names()
              if scope.get_var(n) is not None
              and not callable(scope.get_var(n))}
    specs = [{"x": ((b, s, 4), "float32")} for b in (1, 2) for s in (8, 16)]
    assert exe.warmup(prog, specs, fetch_list=pred._fetch_targets,
                      scope=scope) == 4
    assert exe.warmup(prog, specs, fetch_list=pred._fetch_targets,
                      scope=scope) == 0
    assert sorted(n for n in scope.local_var_names()
                  if scope.get_var(n) is not None
                  and not callable(scope.get_var(n))) == sorted(before)
    for k, v in before.items():
        np.testing.assert_array_equal(_bytes(scope.get_var(k)), v)
    p["stat_reset"]()
    pred.run({"x": np.zeros((2, 16, 4), "f4")})
    assert p["stat_get"]("executor_compile") == 0
    assert p["stat_get"]("executor_cache_hit") == 1


def _sgd_program(which):
    p = PKG[which]
    main, startup = p["program"].Program(), p["program"].Program()
    main.random_seed = 5
    with p["unique"].guard(), p["program"].program_guard(main, startup):
        x = p["layers"].data("x", [4])
        loss = p["layers"].mean(p["layers"].fc(x, 1, bias_attr=False))
        p["sgd"](learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_warmup_keeps_training_state_and_training_continues():
    """``test_serving.py``'s donated-state case in both packages from
    one start: warmup of a new shape compiles 1 entry and leaves the
    weight as it was; the losses before and after agree."""
    feed = {"x": np.random.RandomState(0).rand(2, 4).astype("f4")}
    spec = [{"x": ((8, 4), "float32")}]
    init, got = None, {}
    for which in ("jax", "torch"):
        p = PKG[which]
        main, startup, loss = _sgd_program(which)
        exe = p["pkg"].Executor(p["pkg"].CPUPlace())
        if init is None:
            sc = p["pkg"].framework.Scope()
            exe.run(startup, scope=sc)
            init = {v.name: np.asarray(sc.get_var(v.name)).copy()
                    for v in startup.global_block.vars.values()
                    if v.persistable}
        else:
            sc = scope_from_numpy(init, device="cpu")
        w = main.all_parameters()[0].name
        losses = [float(np.ravel(exe.run(main, feed=feed, fetch_list=[loss],
                                         scope=sc)[0])[0])]
        before = _bytes(sc.get_var(w)).copy()
        assert exe.warmup(main, spec, fetch_list=[loss], scope=sc) == 1
        np.testing.assert_array_equal(_bytes(sc.get_var(w)), before)
        losses.append(float(np.ravel(exe.run(
            main, feed=feed, fetch_list=[loss], scope=sc)[0])[0]))
        got[which] = (losses, _bytes(sc.get_var(w)))
    assert got["torch"][0][1] < got["torch"][0][0]
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], atol=F32_TOL)
    np.testing.assert_allclose(got["torch"][1], got["jax"][1], atol=F32_TOL)


@BOTH
def test_warmup_requires_fetch_contract(which):
    p = PKG[which]
    exe = p["pkg"].Executor(p["pkg"].CPUPlace())
    with pytest.raises(ValueError, match="fetch"):
        exe.warmup(p["program"].Program(), [{"x": ((1, 4), "float32")}])


def test_run_persistent_matches_jax():
    """The same fn on the same numpy state: the same outputs and new
    scope state in both packages, the same KeyError and ValueError, and
    the executor's counters moved."""
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    a, b, x = (rs.randn(3, 4).astype("f4"), rs.randn(4).astype("f4"),
               rs.randn(3, 4).astype("f4"))

    def fn(xp):
        def step(state, arg):
            sa, sb = state
            return (((sa * arg).sum(1) + sb[:3],), (sa + arg, sb * 2))
        return step

    jsc = jpkg.framework.Scope()
    jsc.set_var("a", jnp.asarray(a))
    jsc.set_var("b", jnp.asarray(b))
    tsc = scope_from_numpy({"a": a, "b": b}, device="cpu")
    jexe, texe = jpkg.Executor(jpkg.CPUPlace()), tpkg.Executor(
        tpkg.CPUPlace())
    tstat_reset()
    jout = jexe.run_persistent(fn(jnp), ["a", "b"], (jnp.asarray(x),),
                               scope=jsc)
    tout = texe.run_persistent(fn(torch), ["a", "b"], (torch.from_numpy(x),),
                               scope=tsc)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-6)
    for n in ("a", "b"):
        np.testing.assert_allclose(tsc.get_var(n).numpy(),
                                   np.asarray(jsc.get_var(n)), rtol=1e-6)
    assert [tstat_get(c) for c in ("executor_run",
                                   "executor_steps_dispatched",
                                   "executor_steps_drained")] == [1, 1, 1]
    for exe, sc, arg in ((jexe, jsc, jnp.asarray(x)),
                         (texe, tsc, torch.from_numpy(x))):
        with pytest.raises(KeyError, match="missing"):
            exe.run_persistent(fn(None), ["a", "missing"], (arg,), scope=sc)
        with pytest.raises(ValueError, match="1 state values for 2"):
            exe.run_persistent(lambda st, v: ((), (st[0],)), ["a", "b"],
                               (arg,), scope=sc)


# -- last-use frees ------------------------------------------------------

B, S, V, P = 2, 128, 64, 3
BERT_CFG = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=128,
                n_layers=2, n_heads=2, ffn_size=256, dropout_prob=0.0,
                lr=1e-3, max_preds_per_seq=P)


def _bert(which):
    p = PKG[which]
    bert = jbert if which == "jax" else tbert
    with p["unique"].guard():
        main, startup, _feeds, loss, opt = bert(**BERT_CFG)
        main.random_seed = 1
        with p["program"].program_guard(main, startup):
            opt.minimize(loss)
    return main, startup, loss


def _bert_feed(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, S)).astype("int64")
    flat_pos = np.concatenate([b * S + rs.choice(S, P, replace=False)
                               for b in range(B)]).astype("int64")
    mask = np.zeros((B, 1, 1, S), "float32")
    mask[1, 0, 0, -1] = -1e4
    return {"input_ids": ids,
            "token_type_ids": (rs.rand(B, S) < 0.5).astype("int64"),
            "pos_ids": np.tile(np.arange(S, dtype="int64"), (B, 1)),
            "input_mask": mask, "masked_flat_pos": flat_pos,
            "masked_labels": ids.reshape(-1)[flat_pos].reshape(-1, 1),
            "masked_weights": np.ones((B * P, 1), "float32"),
            "nsp_labels": rs.randint(0, 2, (B, 1)).astype("int64")}


def test_last_use_frees_change_no_output_and_lower_the_peak(monkeypatch):
    """A tiny BERT step with frees against the JAX executor (1e-4), and
    against the port's own step with a free plan that frees nothing; the
    block holds fewer values at its peak with frees than without."""
    jmain, jstartup, jloss = _bert("jax")
    jsc = jpkg.framework.Scope()
    jexe = jpkg.Executor(jpkg.CPUPlace())
    jexe.run(jstartup, scope=jsc)
    init = {v.name: np.asarray(jsc.get_var(v.name))
            for v in jstartup.global_block.vars.values() if v.persistable}
    feed = _bert_feed()
    jl = float(np.ravel(jexe.run(jmain, feed=feed, fetch_list=[jloss],
                                 scope=jsc)[0])[0])
    tmain, _tstartup, tloss = _bert("torch")
    plan = texecutor._free_plan
    runs = {}
    for free in (True, False):
        if not free:
            monkeypatch.setattr(texecutor, "_free_plan", lambda p, keep: tuple(
                () for _ in plan(p, keep)))
        exe = tpkg.Executor(tpkg.CPUPlace())
        sc = scope_from_numpy(init, device="cpu")
        feeds = texecutor._feed_tensors(tmain.global_block, feed, exe.device)
        prog = exe._apply_graph_passes(tmain, (tloss.name,), feeds, sc)
        loss = exe._run_block(prog, feeds, (tloss.name,), sc)[0]
        runs[free] = (float(loss.ravel()[0]), exe.env_peak,
                      {n: sc.get_var(n).numpy() for n in init})
    assert runs[True][0] == runs[False][0]
    for n in init:
        np.testing.assert_allclose(runs[True][2][n], runs[False][2][n],
                                   atol=SELF_TOL)
    assert runs[True][1] < runs[False][1]
    assert abs(runs[True][0] - jl) <= F32_TOL
    for n in init:
        np.testing.assert_allclose(runs[True][2][n], np.asarray(
            jsc.get_var(n)), atol=F32_TOL)


def test_free_plan_keeps_feeds_state_and_fetches():
    """Each value goes after its last use; feeds, state written back and
    fetches stay to the end."""
    main, startup = tprogram.Program(), tprogram.Program()
    with tunique.guard(), tprogram.program_guard(main, startup):
        x = tlayers.data("x", [4])
        h = tlayers.fc(x, 3, act="relu")
        loss = tlayers.mean(h)
        TSGD(learning_rate=0.1).minimize(loss)
    keep = {"x", loss.name} | {p.name for p in main.all_parameters()}
    frees = texecutor._free_plan(main, keep)
    ops = main.global_block.ops
    dropped = [n for f in frees for n in f]
    assert len(dropped) == len(set(dropped))
    assert not keep & set(dropped)
    for i, names in enumerate(frees):
        for n in names:
            assert n in ops[i].input_arg_names() + ops[i].output_arg_names()
            assert all(n not in op.input_arg_names() + op.output_arg_names()
                       for op in ops[i + 1:])
    used = {n for op in ops for n in op.input_arg_names()
            + op.output_arg_names()}
    assert set(dropped) == used - keep


# -- the capture decision ------------------------------------------------

def test_eager_only_for_a_reason_in_the_op_list(tmp_path):
    """A seeded dropout and a host I/O program run eagerly, counted and
    named in an ``executor/eager`` span; an unseeded dropout does not."""
    progs = {}
    for seed in (0, 11):
        main, startup = tprogram.Program(), tprogram.Program()
        with tunique.guard(), tprogram.program_guard(main, startup):
            x = tlayers.data("x", [8])
            y = tlayers.dropout(x, 0.5, seed=seed or None)
        progs[seed] = (main, y)
    assert texecutor.capture_reason(progs[0][0]) is None
    kind, why = texecutor.capture_reason(progs[11][0])
    assert kind == "seeded_random" and "dropout" in why and "11" in why
    save = tio._io_program([progs[0][1]], str(tmp_path), None, "save")
    kind, why = texecutor.capture_reason(save)
    assert kind == "host_io" and "save" in why

    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    tstat_reset()
    tflags.set_flags({"enable_tracer": True})
    tobserve.tracer.clear()
    try:
        exe.run(progs[11][0], feed={"x": np.ones((2, 8), "f4")},
                fetch_list=[progs[11][1]], scope=sc)
        sc.set_var(progs[0][1].name, np.ones((2, 8), "f4"))
        exe.run(save, scope=sc)
        spans = [s for s in tobserve.tracer.snapshot()
                 if s.name == "executor/eager"]
    finally:
        tflags.set_flags({"enable_tracer": False})
    assert tstat_get("executor_eager_seeded_random") == 1
    assert tstat_get("executor_eager_host_io") == 1
    assert [dict(s.args)["reason"] for s in spans] == [
        texecutor.capture_reason(progs[11][0])[1],
        texecutor.capture_reason(save)[1]]


def _builder_programs():
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.text import static_models as sm
    from paddle_tpu_torch.vision import resnet50_train_program

    out = {}
    for label, fused, amp, drop in (("bert_fused_bf16", True, True, 0.1),
                                    ("bert_unfused_f32", False, False, 0.0)):
        with tunique.guard():
            main, startup, _f, loss, opt = tbert(
                **dict(BERT_CFG, dropout_prob=drop),
                use_fused_attention=fused)
            with tprogram.program_guard(main, startup):
                (decorate(opt, use_bf16=True) if amp else opt).minimize(loss)
        out[label] = main
    main, startup = tprogram.Program(), tprogram.Program()
    with tunique.guard(), tprogram.program_guard(main, startup):
        ids, types, pos = (tlayers.data(n, [-1, S], dtype="int64",
                                        append_batch_size=False)
                           for n in ("input_ids", "token_type_ids",
                                     "pos_ids"))
        mask = tlayers.data("input_mask", [-1, 1, 1, S], dtype="float32",
                            append_batch_size=False)
        sm.bert_encoder(ids, types, pos, mask, dropout_prob=0.0,
                        vocab_size=V, hidden=128, n_layers=2, n_heads=2,
                        ffn_size=256)
    out["bert_encoder"] = main
    with tunique.guard():
        main, startup, _f, loss, opt = resnet50_train_program(
            lr=0.1, momentum=0.9, img_shape=(3, 32, 32))
        with tprogram.program_guard(main, startup):
            decorate(opt, use_bf16=True).minimize(loss)
    out["resnet50_bf16"] = main
    return out


@pytest.mark.parametrize("label", ["bert_fused_bf16", "bert_unfused_f32",
                                   "bert_encoder", "resnet50_bf16"])
def test_builders_programs_capture(label):
    """The four programs the card runs captured have no reason to run
    eagerly."""
    assert texecutor.capture_reason(_builder_programs()[label]) is None


def test_two_feed_shapes_make_two_entries():
    main, startup, loss = _sgd_program("torch")
    exe = tpkg.Executor(tpkg.CPUPlace())
    sc = tpkg.framework.Scope()
    exe.run(startup, scope=sc)
    tstat_reset()
    for b in (2, 3, 2):
        exe.run(main, feed={"x": np.ones((b, 4), "f4")},
                fetch_list=[loss], scope=sc)
    assert tstat_get("executor_compile") == 2
    assert tstat_get("executor_cache_hit") == 1
    assert tstat_get("executor_run") == 3


# -- the capture path, with a replay that runs the recorded step ---------

class _RecordedStep:
    """``StepGraph``'s contract without a card: ``capture`` records the
    step without running it, each ``replay`` runs what was recorded."""

    def __init__(self, device, error_mode="global"):
        self.graph, self.outputs, self.launches = None, None, ()

    def on_side_stream(self, fn):
        return fn()

    def capture(self, fn, generators=()):
        self.graph, self._fn = True, fn

    def replay(self):
        self.outputs = self._fn()


def _momentum_dropout_program():
    main, startup = tprogram.Program(), tprogram.Program()
    main.random_seed = 9
    with tunique.guard(), tprogram.program_guard(main, startup):
        x = tlayers.data("x", [6])
        h = tlayers.dropout(tlayers.fc(x, 5, act="relu"), 0.3,
                            dropout_implementation="upscale_in_train")
        loss = tlayers.mean(tlayers.fc(h, 1))
        TMomentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return main, startup, loss


def test_captured_path_matches_eager(monkeypatch):
    """Two executors from one startup over 7 steps of a momentum program
    with dropout: one eager, one through the capture path (warm-up,
    capture, replays), each warmed up first on a scope that has no
    generator yet, with a weight rebound by ``set_var`` before step 3,
    an eager block between, and a state-neutral warmup of another
    shape.  Losses, fetched state and final state are equal; a fetched
    state tensor is a copy that later steps leave alone."""
    monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    main, startup, loss = _momentum_dropout_program()
    w = main.all_parameters()[0].name
    rs = np.random.RandomState(4)
    feeds = [{"x": rs.rand(3, 6).astype("f4")} for _ in range(7)]
    init_exe = tpkg.Executor(tpkg.CPUPlace())
    init = tpkg.framework.Scope()
    init_exe.run(startup, scope=init)
    new_w = rs.rand(*init.get_var(w).shape).astype("f4")
    results = {}
    for captured in (False, True):
        exe = tpkg.Executor(tpkg.CPUPlace())
        exe._captures = captured
        sc = tpkg.framework.Scope()
        for n in init.local_var_names():
            if isinstance(init.get_var(n), torch.Tensor):
                sc.set_var(n, init.get_var(n).clone())
        losses, fetched = [], None
        # captured here, so the first run replays into a scope that has
        # no generator yet
        assert exe.warmup(main, [feeds[0]], fetch_list=[loss],
                          scope=sc) == 1
        for i, feed in enumerate(feeds):
            if i == 2:
                sc.set_var(w, new_w)
            if i == 3:
                fd = texecutor._feed_tensors(main.global_block, feed,
                                             exe.device)
                prog = exe._apply_graph_passes(main, (loss.name,), fd, sc)
                out = exe._run_block(prog, fd, (loss.name,), sc)
                losses.append(float(out[0].ravel()[0]))
                continue
            if i == 5:
                assert exe.warmup(main, [{"x": ((5, 6), "float32")}],
                                  fetch_list=[loss], scope=sc) == 1
            out = exe.run(main, feed=feed, fetch_list=[loss, w], scope=sc,
                          return_numpy=False)
            losses.append(float(out[0].ravel()[0]))
            if i == 4:
                fetched = (out[1], out[1].clone())
        assert torch.equal(*fetched)
        results[captured] = (losses, {n: sc.get_var(n).clone()
                                      for n in init.local_var_names()
                                      if isinstance(sc.get_var(n),
                                                    torch.Tensor)})
        if captured:
            assert all(e.graph is not None for e in exe._cache.values()
                       if e.program is not startup)
    assert results[True][0] == results[False][0]
    for n, v in results[False][1].items():
        assert torch.equal(results[True][1][n], v), n
