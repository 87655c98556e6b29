"""PyTorch port: the sequence ops, the CRF, the sampled losses and the
rest of the op library in one program, through dygraph's
``Tracer.trace_op``, and counted against the JAX package.

- One program of several of these ops (``sequence_pad`` into
  ``sequence_pool``, ``sequence_conv`` and ``row_conv``,
  ``linear_chain_crf`` and ``crf_decoding``, ``masked_select``,
  ``histogram``, ``bincount``, ``unpool``, ``spectral_norm``,
  ``shuffle_batch`` and an unseeded ``sample_logits``, which draw from
  the program's stream) with the CRF's gradient runs through the
  capture path (a recording stand-in for the CUDA graph,
  ``exe._captures = True``) and eagerly, three runs each from one
  seed: every fetch equal, no eager counter moved by the captured one.
- ``capture_reason``: ``shape_tensor`` for ``sequence_slice`` and for
  ``affine_grid`` with an ``OutputShape`` tensor, ``seeded_random`` for a
  seeded ``nce`` / ``sample_logits``, None for every other one-op
  program of this slice's parity tests.
- ``sequence_conv`` through ``Tracer.trace_op`` in both packages equals
  the static program's result, and so does its filter's gradient.
- ``tools/port_coverage.py``'s ``main()`` counts 402 lowerings, 398 of
  them the JAX package's, none missing (``layer_scan`` and
  ``layer_index``, the last two, came with scan-over-layers), and 47
  unresolved ``API.spec`` names.

Tolerance: 1e-5 absolute plus 1e-5 relative (float32); captured and
eager runs are equal.
"""
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
import test_torch_crf_ops
import test_torch_lowerings as tl
import test_torch_misc_ops
import test_torch_select_ops
import test_torch_sequence_ops
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework.backward import calc_gradient
from paddle_tpu_torch.monitor import stat_get
from test_torch_executor_graph import _RecordedStep
from torch_dygraph_parity import _jax_eager_keys_kept  # noqa: F401
from test_torch_sampling_ops import _nce_case, _sample_logits_case

TOL = dict(atol=1e-5, rtol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values():
    rs = np.random.RandomState(8)
    f = lambda *s: rs.randn(*s).astype("f4")  # noqa: E731
    return {
        "tokens": f(24, 5), "pad": np.zeros(1, "f4"),
        "lens": np.array([6, 1, 0, 4], "int64"),
        "filt": f(15, 4), "look": f(3, 5),
        "emission": f(4, 6, 3), "trans": f(5, 3),
        "label": rs.randint(0, 3, (4, 6)).astype("int64"),
        "mask": rs.rand(4, 6, 3) < 0.5,
        "ids": rs.randint(-2, 9, (30,)).astype("int64"),
        "pooled": f(2, 3, 2, 2),
        "where": rs.randint(0, 16, (2, 3, 2, 2)).astype("int32"),
        "weight": f(4, 3, 2), "u": f(4), "v": f(6),
        "logits": f(4, 40), "targets": rs.randint(0, 40, (4, 1)).astype(
            "int64"),
        "rows": f(8, 3), "nll@COT": np.cos(np.arange(4, dtype="f4"))[:, None],
    }


OPS = (
    ("sequence_pad", {"X": ["tokens"], "PadValue": ["pad"],
                      "Length": ["lens"]}, {"Out": ["padded"]},
     {"padded_length": 7}),
    ("sequence_pool", {"X": ["padded"]}, {"Out": ["pooled_max"],
                                          "MaxIndex": ["argmax"]},
     {"pooltype": "MAX"}),
    ("sequence_conv", {"X": ["tokens"], "Filter": ["filt"]},
     {"Out": ["conv"]}, {"contextLength": 3, "contextStart": -1}),
    ("row_conv", {"X": ["tokens"], "Filter": ["look"]}, {"Out": ["ahead"]},
     {}),
    ("linear_chain_crf", {"Emission": ["emission"], "Transition": ["trans"],
                          "Label": ["label"], "Length": ["lens"]},
     {"LogLikelihood": ["nll"]}, {}),
    ("crf_decoding", {"Emission": ["emission"], "Transition": ["trans"],
                      "Length": ["lens"]}, {"ViterbiPath": ["path"]}, {}),
    ("masked_select", {"X": ["emission"], "Mask": ["mask"]},
     {"Y": ["selected"], "Count": ["count"]}, {}),
    ("histogram", {"X": ["tokens"]}, {"Out": ["hist"]},
     {"bins": 8, "min": -2, "max": 2}),
    ("bincount", {"X": ["ids"]}, {"Out": ["bins"]}, {"minlength": 7}),
    ("unpool", {"X": ["pooled"], "Indices": ["where"]},
     {"Out": ["unpooled"]}, {"ksize": [2, 2], "strides": [2, 2]}),
    ("spectral_norm", {"Weight": ["weight"], "U": ["u"], "V": ["v"]},
     {"Out": ["normed"]}, {"power_iters": 2}),
    ("shuffle_batch", {"X": ["rows"]}, {"Out": ["shuffled"],
                                        "ShuffleIdx": ["perm"]}, {}),
    ("sample_logits", {"Logits": ["logits"], "Labels": ["targets"]},
     {"SampledLogits": ["sampled"], "Samples": ["samples"]},
     {"num_samples": 5, "sampler": 1}),
)


def _program(values):
    prog = tprogram.Program()
    prog.random_seed = 11
    blk = prog.global_block
    for name, a in values.items():
        blk.create_var(name=name, shape=a.shape, dtype=a.dtype.name,
                       stop_gradient=name not in ("emission", "trans"))
    fetch = []
    for op_type, ins, outs, attrs in OPS:
        for names in outs.values():
            for n in names:
                blk.create_var(name=n)
                fetch.append(n)
        blk.append_op(op_type, ins, outs, attrs)
    seed = blk.create_var(name="nll@COT", shape=(4, 1), dtype="float32")
    grads = calc_gradient([blk.var("nll")], [blk.var("emission"),
                                             blk.var("trans")], [seed])
    return prog, fetch + [g.name for g in grads]


def _eager_counts():
    return {k: stat_get("executor_eager_" + k) for k in
            ("shape_tensor", "seeded_random", "host_sync", "control_flow")}


def test_captured_program_equals_eager(monkeypatch):
    monkeypatch.setattr(texecutor, "StepGraph", _RecordedStep)
    values = _values()
    prog, fetch = _program(values)
    assert texecutor.capture_reason(prog) is None
    results = {}
    for captured in (False, True):
        exe = T.Executor(T.CPUPlace())
        exe._captures = captured
        scope = T.framework.Scope()
        before = _eager_counts()
        results[captured] = [exe.run(prog, feed=values, fetch_list=fetch,
                                     scope=scope) for _ in range(3)]
        assert _eager_counts() == before
        if captured:
            assert all(e.graph is not None for e in exe._cache.values())
    for eager, capt in zip(results[False], results[True]):
        for name, a, b in zip(fetch, eager, capt):
            np.testing.assert_array_equal(a, b, err_msg=name)
    # the program's stream moves on between runs
    perms = [r[fetch.index("perm")] for r in results[True]]
    assert any((perms[0] != p).any() for p in perms[1:])


def _all_cases():
    for mod in (test_torch_sequence_ops, test_torch_crf_ops,
                test_torch_select_ops, test_torch_misc_ops):
        for name, cases in mod.CASES.items():
            for c in cases:
                yield name, c
    for s in (0, 1, 2):
        yield "nce", _nce_case(s)
        yield "sample_logits", _sample_logits_case(s)


def test_capture_reasons():
    seen = set()
    for name, c in _all_cases():
        prog = tl._build("torch", c)[0]
        want = ("seeded_random" if c["attrs"].get("seed") else None)
        reason = texecutor.capture_reason(prog)
        assert (reason and reason[0]) == want, (name, reason)
        seen.add(c["type"])
    assert len(seen) >= 38
    for op_type, ins in (
            ("sequence_slice", dict(X=[np.ones((4, 2), "f4")],
                                    Offset=[np.array([1], "int64")],
                                    Length=[np.array([2], "int64")])),
            ("affine_grid", dict(Theta=[np.ones((1, 2, 3), "f4")],
                                 OutputShape=[np.array([1, 1, 3, 3],
                                                       "int32")]))):
        prog = tl._build("torch", tl._case(op_type, ins, ["Out"]))[0]
        assert texecutor.capture_reason(prog)[0] == "shape_tensor"


def test_trace_op_matches_static():
    """``sequence_conv`` through ``Tracer.trace_op`` in both packages, its
    output and the filter's gradient, against the port's static
    program."""
    rs = np.random.RandomState(4)
    x, filt = rs.randn(9, 4).astype("f4"), rs.randn(12, 3).astype("f4")
    w = np.cos(np.arange(27, dtype="f4")).reshape(9, 3)
    attrs = {"contextLength": 3, "contextStart": -1}
    got = []
    for pkg in (J, T):
        xt = pkg.to_tensor(x)
        ft = pkg.to_tensor(filt, stop_gradient=False)
        out = pkg.to_tensor(np.zeros((9, 3), "f4"))
        pkg.dygraph.eager.tracer().trace_op(
            "sequence_conv", {"X": xt, "Filter": ft}, {"Out": out}, attrs)
        (out * pkg.to_tensor(w)).sum().backward()
        got.append((np.asarray(out.numpy()), np.asarray(ft.grad.numpy())))
    c = tl._case("sequence_conv", dict(X=[x], Filter=[filt]), ["Out"], attrs)
    prog, feed, fetch = tl._build("torch", c, {"out_out": w})
    static = dict(zip(fetch, tl._run("torch", prog, feed, fetch)))
    for out, grad in got:
        np.testing.assert_allclose(out, static["out_out"], **TOL)
        np.testing.assert_allclose(grad, static["filter_0@GRAD"], **TOL)


def test_port_coverage_counts():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import port_coverage
    finally:
        sys.path.pop(0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_coverage.main()
    counts = json.loads(buf.getvalue())
    assert counts["lowerings_port"] == 402
    assert counts["lowerings_port_of_jax"] == 398
    assert counts["lowerings_missing"] == 0
    # 47 before FuseAllReducePass (and its apply / should_apply) came,
    # 44 before the elastic supervisor's 13
    assert counts["api_spec_unresolved"] == 31
    import paddle_tpu.framework.lowering as jl
    import paddle_tpu_torch.framework.lowering as tlow

    assert set(jl.LOWERINGS) - set(tlow.LOWERINGS) == set()


@pytest.mark.parametrize("op_type", ["nce", "sample_logits"])
def test_seeded_sampled_losses_run_eagerly(op_type):
    c = _nce_case(0) if op_type == "nce" else _sample_logits_case(0)
    prog = tl._build("torch", c)[0]
    assert texecutor.capture_reason(prog)[0] == "seeded_random"
