"""PyTorch port: the recurrent ops (``ops/rnn_ops.py``) and layers
(``nn.LSTM``, ``GRU``, ``SimpleRNN``) against the JAX package's, on the
CPU.

- ``rnn``: one-op programs built with each package's IR and run through
  each package's executor, from the same seeded inputs and output
  cotangents, with the generic gradient op after the op (``jax.vjp`` of
  the lowering in the JAX package, autograd through the replayed
  forward in the port); every output and every input gradient (input,
  initial states, each weight) is compared.  The port's lowering runs
  torch's fused recurrent op; the step-by-step reference it keeps
  (``rnn_reference``) is held to that fused route in float64.
- The fluid-era cell and sequence ops the same way.
- The layers: the JAX layer's ``state_dict()`` carried into the port's
  (``torch_dygraph_parity.pair``), then the same input through both:
  outputs, final states and every gradient.

Tolerances:
- float32 against the JAX package, 2e-5 of the JAX result's largest
  magnitude: both sides compute in float32 in other summation orders
  (cuDNN-style fused gates against a scan), compounded over 5 steps and
  2 layers of O(1) values; a wrong gate order or bias moves results by
  O(0.1);
- float64, fused route against the step reference, 1e-12 absolute: the
  same arithmetic in another order, 1e-16 an operation;
- dropout between layers: the kept share of a 2 x 400 x 64 tensor within
  5 standard deviations of 1 - p.
"""
import numpy as np
import pytest
import torch

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, check, pair, to_numpy)
from test_torch_lowerings import PACKAGES, _run

from paddle_tpu_torch.ops import rnn_ops

RTOL = 2e-5
GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}
MODES = sorted(GATES)


def _program(which, op_type, inputs, outs, attrs, cotangents=None):
    """One-op program whose output slots may hold several vars (``outs``:
    slot -> count); with cotangents, the op's gradient op after it.
    Returns (program, feed, fetch)."""
    _pkg, prog_mod, bw = PACKAGES[which]
    prog = prog_mod.Program()
    blk = prog.global_block
    feed, ins = {}, {}
    for slot, arrays in inputs.items():
        ins[slot] = []
        for i, a in enumerate(arrays):
            name = f"{slot.lower()}_{i}"
            blk.create_var(name=name, shape=a.shape, dtype=a.dtype.name,
                           stop_gradient=False)
            feed[name] = a
            ins[slot].append(name)
    out_names = {s: [f"out_{s.lower()}_{i}" for i in range(n)]
                 for s, n in outs.items()}
    for names in out_names.values():
        for n in names:
            blk.create_var(name=n)
    op = blk.append_op(op_type, ins, out_names, attrs)
    fetch = [n for ns in out_names.values() for n in ns]
    if cotangents:
        out_grads = {}
        for name, cot in cotangents.items():
            gname = prog_mod.grad_var_name(name)
            blk.create_var(name=gname, shape=cot.shape, dtype=cot.dtype.name)
            feed[gname] = cot
            out_grads[name] = gname
        bctx = bw.BackwardContext(blk, ())
        gop = bw.GRAD_MAKERS.get(op.type, bw.default_grad_maker)(
            bctx, op, out_grads)
        for slot, names in gop.outputs.items():
            resolved = []
            for n in names:
                if n.startswith("__pending__"):
                    src = n[len("__pending__"):]
                    n = prog_mod.grad_var_name(src)
                    bctx.ensure_grad_var(n, src)
                resolved.append(n)
            gop.outputs[slot] = resolved
        blk.ops.append(gop)
        prog._bump()
        fetch += [n for ns in gop.outputs.values() for n in ns if n]
    return prog, feed, fetch


def _compare(op_type, inputs, outs, attrs, grad_slots, rtol=RTOL):
    """Outputs and input gradients of the port against the JAX
    package's; cotangents are seeded for the ``grad_slots`` outputs."""
    prog, feed, fetch = _program("torch", op_type, inputs, outs, attrs)
    probe = dict(zip(fetch, _run("torch", prog, feed, fetch)))
    rs = np.random.RandomState(1)
    cots = {n: rs.randn(*probe[n].shape).astype("f4")
            for n in fetch if n.split("_")[1] in grad_slots}
    got = _run("torch", *_program("torch", op_type, inputs, outs, attrs,
                                  cots))
    want = _run("jax", *_program("jax", op_type, inputs, outs, attrs, cots))
    _p, _f, fetch = _program("torch", op_type, inputs, outs, attrs, cots)
    assert len(got) == len(want) == len(fetch) > len(probe)
    for n, g, w in zip(fetch, got, want):
        assert_close(np.asarray(w), np.asarray(g), rtol, f"{op_type} {n}")


def _rnn_inputs(rs, mode, layers, bidi, bias, t=5, b=3, i=4, h=6):
    nd = 2 if bidi else 1
    g = GATES[mode]
    ws, bs = [], []
    for layer in range(layers):
        for _ in range(nd):
            in_sz = i if layer == 0 else h * nd
            ws += [rs.randn(g * h, in_sz).astype("f4") * 0.4,
                   rs.randn(g * h, h).astype("f4") * 0.4]
            bs += [rs.randn(g * h).astype("f4") * 0.2 for _ in range(2)]
    states = [rs.randn(layers * nd, b, h).astype("f4") * 0.5
              for _ in range(2 if mode == "LSTM" else 1)]
    return dict(Input=[rs.randn(t, b, i).astype("f4")], PreState=states,
                WeightList=ws + (bs if bias else []))


@pytest.mark.parametrize("mode", MODES)
def test_rnn_lowering_matches_jax(mode):
    """1 layer; 2 bidirectional layers; 2 layers without bias: Out, the
    final states and the gradients of the input, the initial states and
    every weight."""
    rs = np.random.RandomState(0)
    n_state = 2 if mode == "LSTM" else 1
    for layers, bidi, bias in ((1, False, True), (2, True, True),
                               (2, False, False)):
        attrs = dict(mode=mode, num_layers=layers, is_bidirec=bidi,
                     hidden_size=6, input_size=4, dropout_prob=0.0)
        _compare("rnn", _rnn_inputs(rs, mode, layers, bidi, bias),
                 {"Out": 1, "State": n_state}, attrs, ("out", "state"))


@pytest.mark.parametrize("mode", MODES)
def test_fused_route_matches_step_reference(mode):
    """float64: torch's fused op (the lowering's route) against the
    step-by-step ``rnn_reference``, outputs and gradients."""
    rs = np.random.RandomState(3)
    for layers, bidi, bias in ((1, False, True), (2, True, True),
                               (2, True, False)):
        arrs = _rnn_inputs(rs, mode, layers, bidi, bias)
        vals = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
                for a in arrs["Input"] + arrs["PreState"]
                + arrs["WeightList"]]
        x, h0 = vals[0], vals[1]
        c0 = vals[2] if mode == "LSTM" else None
        ws = vals[1 + len(arrs["PreState"]):]
        results = []
        for fn in (rnn_ops.rnn_fused, rnn_ops.rnn_reference):
            outs = [o for o in fn(mode, x, h0, c0 if c0 is not None
                                  else torch.zeros_like(h0), ws, layers,
                                  bidi) if o is not None]
            if mode != "LSTM":
                outs = outs[:2]
            loss = sum((o * torch.linspace(-1, 1, o.numel(),
                                           dtype=torch.float64
                                           ).reshape(o.shape)).sum()
                       for o in outs)
            grads = torch.autograd.grad(loss, vals, allow_unused=True)
            results.append([o.detach() for o in outs] + [
                torch.zeros_like(v) if g is None else g
                for v, g in zip(vals, grads)])
        for a, b in zip(*results):
            torch.testing.assert_close(a, b, atol=1e-12, rtol=0)


def _cell_cases(rs):
    h = 5
    return {
        "gru_unit": [("gru_unit", dict(
            Input=[rs.randn(3, 3 * h).astype("f4")],
            HiddenPrev=[rs.randn(3, h).astype("f4")],
            Weight=[rs.randn(h, 3 * h).astype("f4") * 0.5],
            Bias=[rs.randn(1, 3 * h).astype("f4")]),
            {"Gate": 1, "ResetHiddenPrev": 1, "Hidden": 1},
            dict(origin_mode=om), ("hidden",)) for om in (False, True)],
        "lstm_unit": [("lstm_unit", dict(
            X=[rs.randn(3, 4 * h).astype("f4")],
            C_prev=[rs.randn(3, h).astype("f4")]),
            {"C": 1, "H": 1}, dict(forget_bias=fb), ("c", "h"))
            for fb in (0.0, 1.0)],
        "gru": [("gru", dict(
            Input=[rs.randn(6, 3 * h).astype("f4")],
            Weight=[rs.randn(h, 3 * h).astype("f4") * 0.5],
            Bias=[rs.randn(1, 3 * h).astype("f4")],
            H0=[rs.randn(h).astype("f4")]),
            {"Hidden": 1, "BatchGate": 1, "BatchResetHiddenPrev": 1,
             "BatchHidden": 1},
            dict(is_reverse=rev, origin_mode=om), ("hidden",))
            for rev, om in ((False, False), (True, True))],
        "lstm": [("lstm", dict(
            Input=[rs.randn(6, 4 * h).astype("f4")],
            Weight=[rs.randn(h, 4 * h).astype("f4") * 0.5],
            Bias=[rs.randn(1, 7 * h if peep else 4 * h).astype("f4")],
            H0=[rs.randn(h).astype("f4")], C0=[rs.randn(h).astype("f4")]),
            {"Hidden": 1, "Cell": 1, "BatchGate": 1, "BatchCellPreAct": 1},
            dict(use_peepholes=peep, is_reverse=peep), ("hidden", "cell"))
            for peep in (False, True)],
        "lstmp": [("lstmp", dict(
            Input=[rs.randn(6, 4 * h).astype("f4")],
            Weight=[rs.randn(3, 4 * h).astype("f4") * 0.5],
            ProjWeight=[rs.randn(h, 3).astype("f4") * 0.5],
            Bias=[rs.randn(1, 4 * h).astype("f4")]),
            {"Hidden": 1, "Cell": 1, "Projection": 1},
            dict(cell_activation="relu"), ("hidden",))],
    }


@pytest.mark.parametrize("op", ["gru_unit", "lstm_unit", "gru", "lstm",
                                "lstmp"])
def test_cell_ops_match_jax(op):
    """The fluid-era ops (plain torch in the port), outputs and input
    gradients, each in two settings where it has them."""
    for case in _cell_cases(np.random.RandomState(5))[op]:
        _compare(*case)


RS = np.random.RandomState(7)
SEQ = RS.randn(3, 5, 4).astype("f4")      # [B, T, I]
SEQ_TM = RS.randn(5, 3, 4).astype("f4")   # [T, B, I]


def _states(n_state, layers_dirs):
    return [RS.randn(layers_dirs, 3, 6).astype("f4") * 0.5
            for _ in range(n_state)]


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_layers_match_jax(cls):
    """Batch-major and time-major, 1 and 2 layers, one and two
    directions, zero and given initial states (and SimpleRNN's relu):
    outputs, final states and every gradient."""
    n_state = 2 if cls == "LSTM" else 1
    configs = [dict(kw={}, x=SEQ, states=None),
               dict(kw=dict(num_layers=2, direction="bidirect"), x=SEQ,
                    states=_states(n_state, 4)),
               dict(kw=dict(time_major=True, num_layers=2), x=SEQ_TM,
                    states=None)]
    if cls == "SimpleRNN":
        configs.append(dict(kw=dict(activation="relu"), x=SEQ, states=None))
    for cfg in configs:
        jl, tl = pair(lambda p: getattr(p.nn, cls)(
            4, 6, **cfg["kw"]))
        if cfg["states"] is None:
            check(jl, tl, cfg["x"], rtol=RTOL)
        else:
            wrap = (tuple if cls == "LSTM" else (lambda s: s[0]))
            check(lambda x, *s: jl(x, wrap(s)), lambda x, *s: tl(x, wrap(s)),
                  cfg["x"], *cfg["states"], rtol=RTOL)
        for (n, a), (_, b) in zip(jl.named_parameters(),
                                  tl.named_parameters()):
            assert_close(to_numpy(a.grad), to_numpy(b.grad), RTOL, n)


def test_dropout_between_layers_statistics():
    """With dropout and 2 layers the layer runs one op per layer with one
    dropout op between them (none after the last): its kept share is
    1 - p within 5 sigma, kept values are scaled by 1 / (1 - p), and the
    output is layer 2 run on the dropped values.  In eval mode it is one
    fused op and no dropout."""
    from paddle_tpu_torch.dygraph import eager

    p = 0.3
    T.seed(11)
    lstm = T.nn.LSTM(4, 64, num_layers=2, dropout=p)
    x = T.to_tensor(np.random.RandomState(2).randn(2, 400, 4).astype("f4"))
    calls, real = [], eager.run_op

    def spy(op_type, inputs, *a, **kw):
        res = real(op_type, inputs, *a, **kw)
        calls.append((op_type, inputs, res))
        return res

    eager.run_op = spy
    try:
        out, _ = lstm(x)
        types = [c[0] for c in calls if c[0] in ("rnn", "dropout")]
        assert types == ["rnn", "dropout", "rnn"]
        (_, d_in, d_out), = [c for c in calls if c[0] == "dropout"]
        xin, xout = to_numpy(d_in["X"]), to_numpy(d_out["Out"])
        kept = xout != 0
        n = kept.size
        assert abs(kept.mean() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
        np.testing.assert_allclose(xout[kept], xin[kept] / (1 - p),
                                   rtol=1e-6)
        second = [c for c in calls if c[0] == "rnn"][1]
        assert second[1]["Input"] is d_out["Out"]
        calls.clear()
        lstm.eval()
        out_eval, _ = lstm(x)
        assert [c[0] for c in calls if c[0] in ("rnn", "dropout")] \
            == ["rnn"]
    finally:
        eager.run_op = real
    assert out.shape == out_eval.shape == [2, 400, 64]


def test_sequence_length_raises_and_zero_state_follows_input():
    """``sequence_length`` raises (both packages); the zero initial state
    is made on the input's device in its dtype (float64 here)."""
    for pkg in (J, T):
        with pytest.raises(NotImplementedError, match="sequence_length"):
            pkg.nn.GRU(4, 6)(pkg.to_tensor(SEQ),
                             sequence_length=pkg.to_tensor(
                                 np.array([5, 4, 3])))
    gru = T.nn.GRU(4, 6)
    x = T.Tensor(torch.tensor(SEQ, dtype=torch.float64))
    state = gru._zero_state(x)
    assert state._value.dtype == torch.float64
    assert state._value.device == x._value.device
    assert state.shape == [1, 3, 6]


def test_nn_and_text_export_every_name_and_the_ops_are_registered():
    """The port's ``nn`` and ``text`` export every public name of the JAX
    package's; this slice's ops have lowerings (none raises the
    later-slice error)."""
    from paddle_tpu_torch.framework.lowering import get_lowering

    for mod in ("nn", "text"):
        want = {n for n in dir(getattr(J, mod)) if not n.startswith("_")}
        got = {n for n in dir(getattr(T, mod)) if not n.startswith("_")}
        assert want <= got, sorted(want - got)
    for op in ("conv2d_transpose", "group_norm", "instance_norm", "rnn",
               "gru_unit", "lstm_unit", "gru", "lstm", "lstmp",
               "gather_tree"):
        assert callable(get_lowering(op))
