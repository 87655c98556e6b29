"""PyTorch port: step-phase attribution (``observe/phases.py``) against
the JAX package's.

The engine fed the same (wall, sync, host, steps) sequences under the
same plan gives equal splits and equal reports; ``build_phase_plan``
over the same tiny BERT program, built by each package's builder, gives
equal predicted fractions and compute seconds (the same FLOPs over the
same peak), and the collective inventory of a program holding one-rank
collectives equals the JAX package's.  The port's executor attributes
every drained step but the compile one, the buckets sum exactly to the
wall, and losses are bit-equal with attribution on and off.
"""
import numpy as np
import pytest

import paddle_tpu as jpkg
import paddle_tpu_torch as tpkg
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.program import Program as JProgram
from paddle_tpu.framework.program import program_guard as jguard
from paddle_tpu.hapi.model_stat import program_flops as jflops
from paddle_tpu.observe import phases as jphases
from paddle_tpu.text import bert_base_pretrain_program as jbert
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.place import CPUPlace
from paddle_tpu_torch.framework.program import Program, program_guard
from paddle_tpu_torch.hapi.model_stat import program_flops as tflops
from paddle_tpu_torch.observe import phases as tphases
from paddle_tpu_torch.optimizer import MomentumOptimizer
from paddle_tpu_torch.text import bert_base_pretrain_program as tbert

PKGS = (jpkg, tpkg)
BERT_CFG = dict(batch_size=2, seq_len=16, vocab_size=64, hidden=32,
                n_layers=2, n_heads=2, ffn_size=64, lr=1e-3,
                max_preds_per_seq=3)
# (wall, sync, host, steps): steady steps, a host-bound one, a sync
# larger than the wall (clamped), a zero step, a two-step drain
SEQUENCES = {
    "steady": [(0.010, 0.006, 0.001, 1)] * 5,
    "mixed": [(0.010, 0.006, 0.001, 1), (0.030, 0.002, 0.020, 1),
              (0.005, 0.009, 0.002, 1), (0.0, 0.0, 0.0, 1),
              (0.040, 0.010, 0.004, 2)],
}
COLLECTIVES = [
    {"id": "bucket0", "op": "c_allreduce_sum", "dtype": "float32",
     "bytes": 4 << 20, "overlap": True},
    {"id": "bucket1", "op": "c_allreduce_sum", "dtype": "float32",
     "bytes": 2 << 20, "overlap": True},
    {"id": "c_allreduce_sum:w", "op": "c_allreduce_sum",
     "dtype": "float32", "bytes": 1 << 20, "overlap": False},
]


@pytest.fixture(autouse=True)
def _clean_phase_plane():
    """Fresh engines and the same flags in both packages."""
    for pkg in PKGS:
        pkg.set_flags({"FLAGS_phase_attribution": True,
                       "FLAGS_device_peak_tflops": 100.0,
                       "FLAGS_phase_interconnect_gbps": 50.0})
    jphases.reset_phases()
    tphases.reset_phases()
    yield
    jphases.reset_phases()
    tphases.reset_phases()
    jpkg.set_flags({"FLAGS_device_peak_tflops": 275.0,
                    "FLAGS_phase_interconnect_gbps": 100.0})
    tpkg.set_flags({"FLAGS_device_peak_tflops": 0.0,
                    "FLAGS_phase_interconnect_gbps": 0.0,
                    "FLAGS_phase_attribution": True,
                    "FLAGS_max_inflight_steps": 2})


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("with_plan", [False, True], ids=["noplan", "plan"])
def test_engine_splits_and_report_equal_jax(seq, with_plan):
    plans = (jphases.PhasePlan(3e9, COLLECTIVES),
             tphases.PhasePlan(3e9, COLLECTIVES)) if with_plan \
        else (None, None)
    engines = (jphases.PhaseEngine(), tphases.PhaseEngine())
    for wall, sync, host, steps in SEQUENCES[seq]:
        j, t = (eng.on_step_drained(wall, sync, host, steps=steps, plan=p)
                for eng, p in zip(engines, plans))
        assert t == j
        assert sum(t.values()) == pytest.approx(max(wall, 0.0), abs=1e-15)
    assert engines[1].report() == engines[0].report()
    assert engines[1].comm_exposed_share() == \
        engines[0].comm_exposed_share()


def test_plan_hide_under_compute_equals_jax():
    for flops in (0.0, 1e9, 1e12):
        j = jphases.PhasePlan(flops, COLLECTIVES)
        t = tphases.PhasePlan(flops, COLLECTIVES)
        assert t.to_dict() == j.to_dict()
        j.update_flops(flops * 2)
        t.update_flops(flops * 2)
        assert t.to_dict() == j.to_dict()


def test_compiled_steps_and_flag_off_are_skipped():
    eng = tphases.PhaseEngine()
    assert eng.on_step_drained(1.0, 0.5, 0.1, compiled=True) is None
    tpkg.set_flags({"FLAGS_phase_attribution": False})
    assert eng.on_step_drained(1.0, 0.5, 0.1) is None
    assert tphases.build_phase_plan(None, []) is None
    assert eng.report()["steps"] == 0


def _bert(pkg):
    unique, build = (junique, jbert) if pkg is jpkg else (tunique, tbert)
    with unique.guard():
        main, _startup, _feeds, _loss, _opt = build(**BERT_CFG)
    return main


def test_bert_predicted_fractions_equal_jax():
    """Each package's plan from its own ``program_flops`` (the port's
    infers a few output shapes the JAX package's leaves unpriced: 5
    FLOPs here), then both from the same count: equal plans."""
    mains = {pkg: _bert(pkg) for pkg in PKGS}
    own = {pkg: flops(mains[pkg])
           for pkg, flops in ((jpkg, jflops), (tpkg, tflops))}
    assert own[tpkg] == pytest.approx(own[jpkg], rel=1e-5)
    for counts in (own, dict.fromkeys(PKGS, own[jpkg])):
        j, t = ((jphases if pkg is jpkg else tphases).build_phase_plan(
            mains[pkg].global_block, mains[pkg].global_block.ops,
            flops_per_step=counts[pkg]) for pkg in PKGS)
        assert t.predicted_fractions() == j.predicted_fractions() == \
            {"compute": 1.0, "comm_exposed": 0.0}
        assert t.ledger == j.ledger == []
    assert t.to_dict() == j.to_dict()


def _collective_program(pkg):
    """fc -> one-rank allreduces of its output, one stamped like a fused
    bucket with the overlap attr, one plain."""
    P, guard, unique = (JProgram, jguard, junique) if pkg is jpkg else \
        (Program, program_guard, tunique)
    layers = pkg.layers
    main, startup = P(), P()
    with unique.guard(), guard(main, startup):
        x = layers.data("x", [64], append_batch_size=False)
        y = layers.fc(layers.reshape(x, [1, 64]), 32)
        block = main.global_block
        for i, attrs in enumerate(({"__comm_id__": "bucket0",
                                    "__comm_overlap__": True}, {})):
            out = block.create_var(name=f"ar_{i}", shape=[1, 32],
                                   dtype="float32")
            block.append_op(type="c_allreduce_sum", inputs={"X": [y.name]},
                            outputs={"Out": [out.name]},
                            attrs={"ring_id": 0, **attrs})
    return main


def test_collective_inventory_equals_jax():
    got = []
    for pkg, mod in ((jpkg, jphases), (tpkg, tphases)):
        main = _collective_program(pkg)
        block = main.global_block
        got.append(mod.collective_inventory(block, block.ops))
    assert got[1] == got[0]
    assert [e["overlap"] for e in got[1]] == [True, False]
    with pytest.raises(NotImplementedError, match="item 8"):
        tphases.collective_inventory(block, block.ops, mesh=object())


def _mlp(seed=1):
    main, startup = Program(), Program()
    main.random_seed = seed
    with tunique.guard(), program_guard(main, startup):
        x = tlayers.data("x", [32])
        label = tlayers.data("label", [1], dtype="int64")
        h = tlayers.fc(x, 32, act="relu")
        loss = tlayers.mean(tlayers.softmax_with_cross_entropy(
            tlayers.fc(h, 10), label))
        MomentumOptimizer(0.05, 0.9).minimize(loss)
    return main, startup, loss


def _train(steps, window=2):
    tpkg.set_flags({"FLAGS_max_inflight_steps": window})
    main, startup, loss = _mlp()
    rs = np.random.RandomState(7)
    scope = tpkg.framework.Scope()
    exe = tpkg.Executor(CPUPlace())
    exe.run(startup, scope=scope)
    handles = [exe.run(main, feed={
        "x": rs.randn(8, 32).astype("f4"),
        "label": rs.randint(0, 10, (8, 1)).astype("int64")},
        fetch_list=[loss], scope=scope) for _ in range(steps)]
    losses = [np.asarray(h[0]).copy() for h in handles]
    exe.close()
    return losses


def test_executor_attributes_all_but_the_compile_step_at_window_2():
    eng = tphases.phase_engine()
    got = []
    orig = eng.on_step_drained

    def record(wall_s, sync_s, host_s, **kw):
        split = orig(wall_s, sync_s, host_s, **kw)
        if split is not None:
            got.append((wall_s, split))
        return split

    eng.on_step_drained = record
    try:
        _train(6)
    finally:
        del eng.on_step_drained
    report = tphases.phases_report()
    assert report["steps"] == 5 == len(got)
    for wall, split in got:
        assert sum(split.values()) == pytest.approx(wall, rel=1e-12)
        assert split["host"] > 0.0 and split["comm_exposed"] == 0.0
    assert report["predicted"]["flops_per_step"] > 0
    assert report["predicted"]["predicted_fractions"]["compute"] == 1.0


def test_losses_bit_equal_with_attribution_on_and_off():
    losses = {}
    for on in (True, False):
        tpkg.set_flags({"FLAGS_phase_attribution": on})
        tphases.reset_phases()
        losses[on] = _train(4)
        assert tphases.phases_report()["steps"] == (3 if on else 0)
    for a, b in zip(losses[True], losses[False]):
        assert np.array_equal(a, b)


def test_no_peak_no_predicted_split():
    """The port's default peak (0) leaves the predicted split empty."""
    tpkg.set_flags({"FLAGS_device_peak_tflops": 0.0,
                    "FLAGS_phase_interconnect_gbps": 0.0})
    plan = tphases.PhasePlan(1e12, COLLECTIVES)
    assert plan.predicted_fractions() == {"compute": 0.0,
                                          "comm_exposed": 0.0}
    assert plan.comm_exposed_s == 0.0
