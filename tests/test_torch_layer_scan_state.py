"""PyTorch port: the state of a layer-scanned program, against the JAX
package's one-process cases of tests/test_layer_scan.py and
tests/test_quant_inference.py.

- A checkpoint of a scanned run (``ckpt.state.snapshot_scope``) holds
  per-layer names and no carrier; restored into an unrolled run it
  continues bit for bit as the scanned run does; and back.
- The flag flipped between runs of one scope: scanned steps then
  unrolled steps equal all-unrolled steps (the unrolled program reads
  and writes the members through their carriers' slices).
- ``LayerScanPlan.ensure_stacked``: the first pack allocates the
  carrier, a concrete member written over a view (a restore) is copied
  into its slice in place, all of them at once too, and the carrier
  keeps its storage (what a captured graph holds).
- The executor's pass cache is keyed by the scan flag and the policy.
- ``recompute_configs`` ``scan_layers`` / ``policy`` stamp the optimizer
  ops and turn the pass on for that program; a policy alone applies
  under ``FLAGS_layer_scan``; an unknown policy is refused.
- ``FLAGS_fuse_passes=0`` still scans; a tensor- or expert-parallel
  marked program (``has_tp_marks`` / ``has_ep_marks``) is refused.
- Weight-only int8 composes with the scan: the ``@WQ`` carrier stacks
  to [6, 32, 32] int8, its scale to (6, 32), and the output equals the
  unscanned quantized run bit for bit.
- A JAX package's scanned scope (carriers and ``StackedParamRef``
  views) carried into the port with ``scope_from_numpy`` continues
  within 1e-5 of the JAX run.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
import torch_layer_scan_models as M
from paddle_tpu_torch.ckpt.state import restore_scope, snapshot_scope
from paddle_tpu_torch.framework import passes as tpasses
from paddle_tpu_torch.framework.passes import LayerScanPlan
from paddle_tpu_torch.framework.scope import StackedParamRef, scope_from_numpy
from paddle_tpu_torch.monitor import stat_get, stat_reset


@pytest.fixture(autouse=True)
def _flags():
    yield
    for p in (J, T):
        M.set_scan(p, False)
        p.set_flags({"FLAGS_weight_quant": "", "FLAGS_fuse_passes": True})


def _fresh(p, **kw):
    main, startup, loss = M.mlp(p, **kw)
    scope = p.framework.Scope()
    exe = p.Executor(p.CPUPlace())
    exe.run(startup, scope=scope)
    return main, loss, scope, exe


def _state(scope):
    return {n: np.asarray(scope.get_var(n)).copy()
            for n in scope.local_var_names()
            if ("blk" in n or "head" in n)
            and not n.startswith(tpasses.LAYER_STACK_PREFIX)}


def test_checkpoint_round_trip_into_unrolled_run():
    data = [M.mlp_data()] * 2
    M.set_scan(T, True)
    main, loss, scope, exe = _fresh(T)
    M.train(T, main, loss, scope, data, exe)
    snap = snapshot_scope(scope)
    assert not any(k.startswith(tpasses.LAYER_STACK_PREFIX) for k in snap)
    assert any("velocity" in k for k in snap)
    assert any(isinstance(scope.get_var(k), StackedParamRef) for k in snap)

    M.set_scan(T, False)
    umain, uloss, uscope, uexe = _fresh(T)
    restore_scope(uscope, snap, device="cpu")
    resumed, _ = M.train(T, umain, uloss, uscope, data, uexe)
    M.set_scan(T, True)
    cont, _ = M.train(T, main, loss, scope, data, exe)
    assert cont == resumed
    # and back: the unrolled state restored over the scanned scope's
    # views is copied into the live carriers at the next scanned step
    restore_scope(scope, snapshot_scope(uscope), device="cpu")
    again, _ = M.train(T, main, loss, scope, data[:1], exe)
    M.set_scan(T, False)
    ref, _ = M.train(T, umain, uloss, uscope, data[:1], uexe)
    assert again == ref


def test_flag_flip_mid_run_continues_bitwise():
    data = [M.mlp_data()] * 2
    main, loss, scope, exe = _fresh(T)
    oracle, _ = M.train(T, main, loss, scope, data * 2, exe)
    M.set_scan(T, True)
    main2, loss2, scope2, exe2 = _fresh(T)
    first, _ = M.train(T, main2, loss2, scope2, data, exe2)
    M.set_scan(T, False)
    rest, _ = M.train(T, main2, loss2, scope2, data, exe2)
    assert oracle == first + rest
    # the unrolled steps wrote through the views into the carriers
    assert isinstance(scope2.get_var("blk3.w"), StackedParamRef)
    np.testing.assert_array_equal(np.asarray(scope2.get_var("blk3.w")),
                                  np.asarray(scope.get_var("blk3.w")))


def test_ensure_stacked_refreshes_in_place():
    scope = T.framework.Scope()
    name = tpasses.LAYER_STACK_PREFIX + "w"
    members = tuple(f"m{i}" for i in range(4))
    plan = LayerScanPlan([{"carrier": name, "members": members,
                           "shape": (3,), "dtype": "float32"}])
    for i, m in enumerate(members):
        scope.set_var(m, np.full((3,), float(i), "f4"))
    plan.ensure_stacked(scope)              # the first pack allocates
    carrier = scope.get_var(name)
    assert tuple(carrier.shape) == (4, 3)
    assert isinstance(scope.get_var("m1"), StackedParamRef)
    plan.ensure_stacked(scope)              # steady state: nothing moves
    assert scope.get_var(name) is carrier
    scope.set_var("m2", np.full((3,), 9.0, "f4"))   # a partial restore
    plan.ensure_stacked(scope)
    assert scope.get_var(name) is carrier
    assert isinstance(scope.get_var("m2"), StackedParamRef)
    np.testing.assert_array_equal(np.asarray(scope.get_var("m2")),
                                  np.full((3,), 9.0, "f4"))
    np.testing.assert_array_equal(np.asarray(scope.get_var("m3")),
                                  np.full((3,), 3.0, "f4"))
    for i, m in enumerate(members):             # a full restore
        scope.set_var(m, np.full((3,), -float(i), "f4"))
    plan.ensure_stacked(scope)
    assert scope.get_var(name) is carrier
    np.testing.assert_array_equal(carrier[:, 0].numpy(), [0, -1, -2, -3])
    assert scope.get_var("m3").device_value().data_ptr() == \
        carrier[3].data_ptr()
    scope.erase(name)
    scope.erase("m0")
    with pytest.raises(RuntimeError, match="'m0' is not initialized"):
        plan.ensure_stacked(scope)


def test_pass_cache_rekeys_on_flag_and_policy_flip():
    data = M.mlp_data()
    M.set_scan(T, True)
    main, loss, scope, exe = _fresh(T)
    stat_reset("executor_pass_cache_hit")
    M.train(T, main, loss, scope, [data], exe)
    assert not stat_get("executor_pass_cache_hit")
    M.train(T, main, loss, scope, [data], exe)
    assert stat_get("executor_pass_cache_hit") == 1
    M.set_scan(T, True, policy="dots_saveable")
    stat_reset("pass_layer_scan_segments")
    M.train(T, main, loss, scope, [data], exe)
    assert stat_get("executor_pass_cache_hit") == 1
    assert stat_get("pass_layer_scan_segments") >= 1
    M.set_scan(T, False)
    stat_reset("pass_layer_scan_segments")
    M.train(T, main, loss, scope, [data], exe)
    assert stat_get("executor_pass_cache_hit") == 1
    assert not stat_get("pass_layer_scan_segments")
    assert sum(k[0] == main.fingerprint() for k in exe._pass_cache) == 3


def _strategy(**rc):
    from paddle_tpu_torch.distributed import fleet

    st = fleet.DistributedStrategy()
    st.recompute = True
    st.recompute_configs = rc
    return st


def test_recompute_configs_scan_layers_enable_per_program():
    from paddle_tpu_torch.distributed import fleet

    data = [M.mlp_data()] * 3
    main, loss, scope, exe = _fresh(T, strategy=fleet.DistributedStrategy())
    base, _ = M.train(T, main, loss, scope, data, exe)
    st = _strategy(scan_layers=4, policy="dots_saveable")
    assert st.recompute_configs["scan_layers"] == 4
    main, loss, scope, exe = _fresh(T, strategy=st)
    stamped = [op for op in main.global_block.ops
               if op.has_attr(tpasses.LAYER_SCAN_ATTR)]
    assert stamped and all(
        op.attr(tpasses.LAYER_SCAN_POLICY_ATTR) == "dots_saveable"
        for op in stamped)
    stat_reset("pass_layer_scan_segments")
    got, _ = M.train(T, main, loss, scope, data, exe)
    assert stat_get("pass_layer_scan_segments") >= 1
    assert got == base


def test_policy_only_recompute_configs_applies():
    M.set_scan(T, True)
    main = M.mlp(T, strategy=_strategy(policy="nothing_saveable"))[0]
    enabled, _, policy = tpasses.LayerScanPass._config(main)
    assert enabled and policy == "nothing_saveable"
    out = tpasses.apply_passes(main, fetch_names=("mean_0.tmp_0",),
                               feed_names=("x", "y"))
    assert {op.attr("remat_policy") for op in out.global_block.ops
            if op.type == "layer_scan"} == {"nothing_saveable"}


def test_invalid_policy_rejected():
    with pytest.raises(ValueError, match="policy"):
        M.mlp(T, strategy=_strategy(scan_layers=4, policy="bogus"))
    M.set_scan(T, True, policy="bogus")
    with pytest.raises(ValueError, match="remat policy"):
        tpasses.apply_passes(M.mlp(T)[0], fetch_names=("mean_0.tmp_0",),
                             feed_names=("x", "y"))


def test_layer_scan_fires_with_fuse_passes_off():
    data = [M.mlp_data()] * 3
    T.set_flags({"FLAGS_fuse_passes": False})
    main, loss, scope, exe = _fresh(T)
    base, _ = M.train(T, main, loss, scope, data, exe)
    M.set_scan(T, True)
    stat_reset("pass_layer_scan_segments")
    main, loss, scope, exe = _fresh(T)
    got, _ = M.train(T, main, loss, scope, data, exe)
    assert stat_get("pass_layer_scan_segments") >= 1
    assert got == base


@pytest.mark.parametrize("mark", [tpasses.TP_RULES_ATTR,
                                  tpasses.EP_DEGREE_ATTR])
def test_tp_or_ep_marked_program_refused(mark):
    main, loss, scope, exe = _fresh(T)
    assert not (tpasses.has_tp_marks(main) or tpasses.has_ep_marks(main))
    opt = next(op for op in main.global_block.ops if op.type == "momentum")
    opt.attrs[mark] = ["w\tNone,mp"] if mark == tpasses.TP_RULES_ATTR else 0
    main._bump()
    assert tpasses.has_tp_marks(main) or tpasses.has_ep_marks(main)
    with pytest.raises(NotImplementedError, match="expert-parallel program"):
        M.train(T, main, loss, scope, [M.mlp_data()], exe)


def test_weight_quant_composes_with_layer_scan():
    # under fresh unique names: the carrier below is read as fc_0's
    main, startup, h = _fc6(T)
    exe = T.Executor(T.CPUPlace())
    scope = T.framework.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(2).randn(4, 32).astype("f4")}
    T.set_flags({"FLAGS_weight_quant": "int8"})
    q_only = np.asarray(exe.run(main, feed=feed, fetch_list=[h],
                                scope=scope)[0])
    stat_reset("pass_layer_scan_segments")
    M.set_scan(T, True)
    q_scan = np.asarray(exe.run(main, feed=feed, fetch_list=[h],
                                scope=scope)[0])
    assert stat_get("pass_layer_scan_segments") >= 1
    carrier = scope.get_var("@LAYER_STACK@fc_0.w_0@WQ")
    assert carrier.dtype == torch.int8 and tuple(carrier.shape) == \
        (6, 32, 32)
    assert tuple(scope.get_var(
        "@LAYER_STACK@fc_0.w_0@WQ_SCALE").shape) == (6, 32)
    assert np.array_equal(q_scan, q_only)


def _fc6(p):
    layers = M._m(p, "layers")
    prog = M._m(p, "framework.program")
    main, startup = prog.Program(), prog.Program()
    main.random_seed = 6
    with M._m(p, "framework.unique_name").guard(), \
            prog.program_guard(main, startup):
        h = layers.data("x", [32])
        for _ in range(6):
            h = layers.fc(h, 32, act="relu")
    return main, startup, h


def test_jax_scanned_scope_carried_into_the_port():
    """A training scope after two JAX scanned steps (carriers beside the
    members its unrolled ops wrote) and an int8 inference scope after a
    JAX scanned run (carriers and ``StackedParamRef`` views of them)
    start the port's scanned and unrolled runs within 1e-5 of the JAX
    package's."""
    data = [M.mlp_data(seed=s) for s in range(4)]
    M.set_scan(J, True)
    jmain, jloss, jscope, jexe = _fresh(J, dropout=0.0)
    M.train(J, jmain, jloss, jscope, data[:2], jexe)
    held = {n: np.asarray(jscope.get_var(n))
            for n in jscope.local_var_names() if n != "@RNG_KEY@"}
    assert any(n.startswith(tpasses.LAYER_STACK_PREFIX) for n in held)
    want, _ = M.train(J, jmain, jloss, jscope, data[2:], jexe)
    for scan in (True, False):
        M.set_scan(T, scan)
        tmain, _s, tloss = M.mlp(T, dropout=0.0)
        got, _ = M.train(T, tmain, tloss, scope_from_numpy(held, "cpu"),
                         data[2:])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    feed = {"x": np.random.RandomState(2).randn(4, 32).astype("f4")}
    J.set_flags({"FLAGS_weight_quant": "int8"})
    T.set_flags({"FLAGS_weight_quant": "int8"})
    jmain, jstart, jh = _fc6(J)
    jscope = J.framework.Scope()
    jexe = J.Executor(J.CPUPlace())
    jexe.run(jstart, scope=jscope)
    want = np.asarray(jexe.run(jmain, feed=feed, fetch_list=[jh],
                               scope=jscope)[0])
    held = {n: jscope.get_var(n) for n in jscope.local_var_names()
            if n != "@RNG_KEY@"}
    assert any(type(v).__name__ == "StackedParamRef" for v in held.values())
    for scan in (True, False):
        M.set_scan(T, scan)
        tmain, _s, th = _fc6(T)
        tscope = scope_from_numpy(held, "cpu")
        got = np.asarray(T.Executor(T.CPUPlace()).run(
            tmain, feed=feed, fetch_list=[th], scope=tscope)[0])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
