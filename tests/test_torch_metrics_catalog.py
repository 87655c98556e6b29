"""PyTorch port: the metrics catalog (``observe/metrics_catalog.py``).

The checked-in ``paddle_tpu_torch/observe/METRICS.md`` is generated from
the rules (a drift gate); every series a clean process exports after a
CPU training step and a CPU decode has a rule; and on each of the JAX
package's rules ``lookup`` and ``unit_of`` agree with the JAX
package's, the port's own rules coming on top.
"""
import os
import subprocess
import sys

from paddle_tpu.observe import metrics_catalog as jcat
from paddle_tpu_torch.observe import metrics_catalog as tcat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = os.path.join(ROOT, "paddle_tpu_torch", "observe", "METRICS.md")

# a fresh interpreter, no JAX: one pipelined CPU training step past its
# compile, one CPU decode, then the exposition
_SCRIPT = r"""
import numpy as np
import torch
import paddle_tpu_torch as pt
from paddle_tpu_torch import layers
from paddle_tpu_torch.framework.place import CPUPlace
from paddle_tpu_torch.framework.program import Program, program_guard
from paddle_tpu_torch.observe.histogram import prometheus_text
from paddle_tpu_torch.optimizer import MomentumOptimizer
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine, TransformerLM

main, startup = Program(), Program()
with program_guard(main, startup):
    x = layers.data("x", [8])
    loss = layers.mean(layers.fc(x, 4))
    MomentumOptimizer(0.1, 0.9).minimize(loss)
scope = pt.framework.Scope()
exe = pt.Executor(CPUPlace())
exe.run(startup, scope=scope)
for _ in range(3):
    exe.run(main, feed={"x": np.ones((2, 8), "f4")}, fetch_list=[loss],
            scope=scope)
exe.close()
model = TransformerLM(31, d_model=16, num_layers=1, num_heads=2,
                      max_seq_len=32, device="cpu")
model.load_weights(model.init_weights(torch.Generator().manual_seed(0)))
eng = DecodeEngine(model, None, DecodeConfig(slots=2, max_seq_len=32,
                                             page_size=8,
                                             max_new_tokens=3))
eng.start()
try:
    eng.submit([1, 2, 3]).result(timeout=120)
finally:
    eng.stop()
print(prometheus_text())
"""


def test_catalog_file_has_not_drifted():
    assert tcat.check_file(CATALOG), (
        "paddle_tpu_torch/observe/METRICS.md drifted from the rules: "
        "python -m paddle_tpu_torch.observe.metrics_catalog --write")
    assert tcat.main(["--check", "--path", CATALOG]) == 0


def test_every_series_of_a_clean_process_has_a_rule():
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                       capture_output=True, text=True, timeout=240,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr[-4000:]
    text = r.stdout
    histograms = {line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE") and line.endswith("histogram")}
    series = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in histograms:
                name = name[:-len(suffix)]
        series.add(name[len("paddle_tpu_"):])
    assert {"executor_steps_drained", "step_time_seconds",
            "phase_compute_seconds_micro", "decode_step_seconds",
            "compile_seconds"} <= series
    undocumented = sorted(n for n in series if tcat.lookup(n) is None)
    assert undocumented == []
    for n in series:
        want = "histogram" if f"paddle_tpu_{n}" in histograms else "gauge"
        assert tcat.lookup(n).type == want, n


def test_lookup_and_units_agree_with_jax_on_its_rules():
    port = list(tcat.RULES)
    assert [r for r in port if r in jcat.RULES] == list(jcat.RULES)
    for rule in jcat.RULES:
        for name in (rule.prefix, rule.prefix + "x_seconds",
                     rule.prefix + "_bytes", rule.prefix + "y_ppm"):
            assert tcat.lookup(name) == jcat.lookup(name), name
            assert tcat.unit_of(name) == jcat.unit_of(name), name
    extra = [r for r in port if r not in jcat.RULES]
    assert {r.prefix for r in extra} == {
        "loader_worker_start_seconds", "hapi_step_time_seconds",
        "executor_eager_", "cuda_graph_"}
