"""PyTorch port: memory accounting and the budget gate
(``observe/xla_stats.py``) against the JAX package's.

``var_attribution``, ``format_attribution`` and ``check_hbm_budget``'s
verdicts equal the JAX package's under a pinned
``FLAGS_hbm_bytes_per_device``; the port's ``on_compile`` record carries
the JAX record's keys (its ``memory`` breakdown the same six), and a
program over the budget raises at its key's first run before any
lowering runs, leaving its numbers in the compile ring and nothing
cached.
"""
import numpy as np
import pytest

import paddle_tpu as jpkg
import paddle_tpu_torch as tpkg
from paddle_tpu.observe import xla_stats as jxla
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.place import CPUPlace
from paddle_tpu_torch.framework.program import Program, program_guard
from paddle_tpu_torch.observe import xla_stats as txla
from paddle_tpu_torch.optimizer import MomentumOptimizer

PKGS = (jpkg, tpkg)
ENTRIES = [("big.w_0", (100, 100), "float32", "state"),
           ("mid.w_0", (10, 10), "float32", "state"),
           ("ids", (16, 8), "int64", "feed"),
           ("tiny.b_0", (4,), "float32", "state"),
           ("x", (16, -1), "float32", "feed"),
           ("mask", (2, 3), "bool", "feed")]


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    for pkg in PKGS:
        pkg.set_flags({"FLAGS_hbm_budget_fraction": 0.0,
                       "FLAGS_hbm_bytes_per_device": 0})


@pytest.mark.parametrize("top_n", [1, 3, 10])
def test_attribution_and_its_table_equal_jax(top_n):
    got = txla.var_attribution(ENTRIES, top_n=top_n)
    assert got == jxla.var_attribution(ENTRIES, top_n=top_n)
    for limit in (None, 2):
        assert txla.format_attribution(got, limit=limit) == \
            jxla.format_attribution(got, limit=limit)
    assert txla.format_attribution([]) == jxla.format_attribution([])


@pytest.mark.parametrize("fraction,capacity,required", [
    (0.0, 1000, 10 ** 15),      # disabled
    (0.9, 0, 10 ** 15),         # no capacity on the CPU: skipped
    (0.5, 1000, 400),           # pass
    (0.5, 1000, 500),           # pass at the budget
    (0.5, 1000, 900),           # rejected
])
def test_budget_verdicts_equal_jax(fraction, capacity, required):
    for pkg in PKGS:
        pkg.set_flags({"FLAGS_hbm_budget_fraction": fraction,
                       "FLAGS_hbm_bytes_per_device": capacity})
    rows = txla.var_attribution(ENTRIES)
    got = []
    for mod in (jxla, txla):
        try:
            got.append(mod.check_hbm_budget(required, rows,
                                            fingerprint="abcd1234"))
        except mod.MemoryBudgetError as e:
            got.append(("rejected", e.required_bytes, e.budget_bytes,
                        e.capacity_bytes, e.attribution))
            assert "big.w_0" in str(e) and "replicated" in str(e)
    assert got[1] == got[0]


class _FakeMemStats:
    argument_size_in_bytes = 1000
    output_size_in_bytes = 500
    temp_size_in_bytes = 300
    generated_code_size_in_bytes = 0
    alias_size_in_bytes = 200


class _FakeCompiled:
    """The JAX tests' duck-typed AOT Compiled, for a JAX record."""

    def memory_analysis(self):
        return _FakeMemStats()

    def cost_analysis(self):
        raise NotImplementedError("no cost analysis")

    def as_text(self):
        return "HloModule fake\n"


class _Entry:
    """What the port's executor hands ``on_compile``: its allocator
    reading, the estimate and the gate's verdict."""
    memory = {"arguments_bytes": 1000, "outputs_bytes": 500,
              "temporaries_bytes": 300, "aliased_bytes": 200}
    estimated_bytes = 1700
    budget = {"verdict": "disabled"}


def test_on_compile_record_has_the_jax_keys():
    kw = dict(fingerprint="deadbeefcafe", seconds=0.25,
              size_entries=ENTRIES[:2])
    want = jxla.on_compile(_FakeCompiled(), **kw)
    got = txla.on_compile(_Entry(), **kw)
    assert got["memory"] == want["memory"]
    assert got["attribution"] == want["attribution"]
    for key in ("fingerprint", "compile_seconds", "n_steps"):
        assert got[key] == want[key]
    assert set(want) - {"executable_size_is_hlo_text", "hlo_text_bytes",
                        "hlo_ops"} <= set(got)
    assert got["estimated_bytes"] == 1700
    assert txla.last_compile() is got
    assert txla.memory_breakdown(object()) is None
    assert txla.cost_flops(_Entry()) is None


def _train_program():
    main, startup = Program(), Program()
    main.random_seed = 3
    with tunique.guard(), program_guard(main, startup):
        x = tlayers.data("x", [64])
        h = tlayers.fc(x, 256, act="relu")
        loss = tlayers.mean(tlayers.fc(h, 8))
        MomentumOptimizer(0.05, 0.9).minimize(loss)
    return main, startup, loss


def test_executor_records_the_estimate_and_the_gate_verdict():
    main, startup, loss = _train_program()
    scope = tpkg.framework.Scope()
    exe = tpkg.Executor(CPUPlace())
    exe.run(startup, scope=scope)
    txla.clear_compile_records()
    tpkg.set_flags({"FLAGS_hbm_budget_fraction": 0.9,
                    "FLAGS_hbm_bytes_per_device": 1 << 30})
    exe.run(main, feed={"x": np.ones((16, 64), "f4")}, fetch_list=[loss],
            scope=scope)
    rec = txla.last_compile()
    # state (weights + velocities) and the feed, at least
    held = 2 * 4 * (64 * 256 + 256 + 256 * 8 + 8) + 16 * 64 * 4
    assert rec["estimated_bytes"] > held
    assert rec["budget"]["verdict"] == "pass"
    assert rec["budget"]["required_bytes"] == rec["estimated_bytes"]
    assert "memory" not in rec          # no caching allocator on the CPU
    assert rec["attribution"][0]["name"] in ("fc_0.w_0",
                                             "fc_0.w_0_velocity_0")
    exe.close()


def test_over_budget_program_raises_before_any_lowering(monkeypatch):
    main, startup, loss = _train_program()
    scope = tpkg.framework.Scope()
    exe = tpkg.Executor(CPUPlace())
    exe.run(startup, scope=scope)
    calls = []
    real = texecutor.get_lowering
    monkeypatch.setattr(texecutor, "get_lowering",
                        lambda t: calls.append(t) or real(t))
    tpkg.set_flags({"FLAGS_hbm_budget_fraction": 0.5,
                    "FLAGS_hbm_bytes_per_device": 100_000})
    n = len(exe._cache)
    for _ in range(2):                  # not cached: judged again
        with pytest.raises(txla.MemoryBudgetError) as ei:
            exe.run(main, feed={"x": np.ones((16, 64), "f4")},
                    fetch_list=[loss], scope=scope)
        assert calls == [] and len(exe._cache) == n
    e = ei.value
    assert e.budget_bytes == 50_000 and e.required_bytes > 50_000
    assert "BEFORE launch" in str(e) and "fc_0.w_0" in str(e)
    assert txla.last_compile()["budget"]["verdict"] == "rejected"
    tpkg.set_flags({"FLAGS_hbm_budget_fraction": 0.0})
    exe.run(main, feed={"x": np.ones((16, 64), "f4")}, fetch_list=[loss],
            scope=scope)
    assert calls
    exe.close()


def test_no_card_no_device_memory():
    assert txla.device_memory_stats() is None
    assert txla.device_memory_stats("cpu") is None
    assert txla.record_device_memory() == {}
    assert txla.device_hbm_capacity() is None
    tpkg.set_flags({"FLAGS_hbm_bytes_per_device": 12345})
    assert txla.device_hbm_capacity() == 12345
    report = txla.memory_report(probe_devices=True)
    assert report["device_memory"] == [] and "compiles" in report
