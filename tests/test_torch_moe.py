"""PyTorch port: the routed expert FFN (``paddle_tpu_torch/ops/moe_ops.py``)
against the JAX package's ``paddle_tpu/ops/moe_ops.py`` on the CPU.

- The router: ``moe_router_ref``'s dense combine, aux loss and expert
  load against the JAX function on the same inputs.  The routing (which
  expert, which slot) and the load are EQUAL -- a choice of indices, the
  same in both when no two router probabilities are within rounding of
  each other -- and the combine and aux within 1e-6 (a float32 softmax
  and its renormalisation, summed in other orders).  Ties (equal logits)
  go to the lower expert index, and capacity drops follow the GShard
  priority (choice 0 of every token before choice 1 of any, then the
  lower token index), both checked against JAX on constructed inputs.
- ``moe_ffn``: one-op programs in both packages, forward and the
  generic gradient of every input (``X``, ``GateW``, ``W1``, ``B1``,
  ``W2``, ``B2``) from the same cotangents: within 1e-5 relative to
  each output's scale (float32 products summed in other orders; the
  port dispatches by index, the JAX package through one-hot einsums).
  The top-k indices carry no gradient and the router's gradient reaches
  ``GateW`` through the aux loss's mean probability.
- A static ``moe_local`` step (x -> moe_ffn -> fc head -> MSE + 0.01 aux,
  Momentum 0.05/0.9, ``bench.py``'s program at a small width) over 3
  steps from the JAX startup: losses within 1e-5 relative.
- ``FLAGS_moe_alltoall_chunks``: chunked and sequential outputs bit
  for bit, with the counters; a capacity the count does not divide falls
  back, counted.
- An ``ep`` stamp raises, naming ROADMAP Queue A item 8.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as T
from paddle_tpu.ops import moe_ops as jmoe
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.ops import moe_ops as tmoe
from test_torch_rnn import _program
from test_torch_lowerings import _run
from torch_fleet_parity import build_both, run_both

E, K, DM, FFN = 4, 2, 16, 32


def _inputs(s=12, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(s, DM).astype("f4"), rs.randn(DM, E).astype("f4")


def _both_routers(x, gw, **kw):
    kw = dict(dict(num_experts=E, top_k=K, capacity_factor=1.25), **kw)
    want = [np.asarray(v) for v in jmoe.moe_router_ref(x, gw, **kw)]
    got = [v.numpy() for v in tmoe.moe_router_ref(
        torch.from_numpy(x), torch.from_numpy(gw), **kw)]
    return got, want


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_router_matches_jax(cf):
    got, want = _both_routers(*_inputs(s=24, seed=1), capacity_factor=cf)
    (gc, ga, gl), (wc, wa, wl) = got, want
    assert gc.shape == wc.shape
    assert np.array_equal(gc > 0, wc > 0)          # same experts, slots
    assert np.array_equal(gl, wl)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ga, wa, rtol=1e-6)
    if cf == 0.5:
        assert gl.sum() < 24 * K                    # drops happen


def test_ties_go_to_the_lower_expert_index():
    """Every logit equal: both choices of every token are experts 0 and
    1, in that order (token t's choice 0 in slot t of expert 0)."""
    x = np.ones((6, DM), "f4")
    gw = np.zeros((DM, E), "f4")
    (gc, _ga, gl), (wc, _wa, wl) = _both_routers(x, gw, capacity_factor=4.0)
    assert np.array_equal(gc, wc) and np.array_equal(gl, wl)
    assert np.array_equal(gl, [6, 6, 0, 0])
    for t in range(6):
        assert gc[t, 0, t] == gc[t, 1, t] == 0.5


def test_capacity_drops_follow_gshard_priority():
    """Tokens 0-3 prefer expert 0 then 1, tokens 4-7 expert 1 then 0; at
    capacity 4 choice 0 fills both experts and every choice 1 is
    dropped, then with one slot more the lowest tokens' choice 1 get in."""
    x = np.zeros((8, DM), "f4")
    x[:4, 0], x[4:, 1] = 1.0, 1.0
    gw = np.zeros((DM, E), "f4")
    gw[0, :2] = [2.0, 1.0]
    gw[1, :2] = [1.0, 2.0]
    for cf, load in ((1.0, [4, 4, 0, 0]), (1.25, [5, 5, 0, 0])):
        (gc, _a, gl), (wc, _b, wl) = _both_routers(
            x, gw, capacity_factor=cf * E / K / 2)
        assert np.array_equal(gl, wl) and np.array_equal(gl, load)
        assert np.array_equal(gc > 0, wc > 0)
    kept_second = gc[:, 1, 4:].sum(axis=1) > 0
    assert kept_second[:4].tolist() == [True, False, False, False]
    assert (gc[4:, 0, 4:].sum(axis=1) > 0).tolist() == [True, False,
                                                          False, False]


def test_balance_gauges_match_jax():
    load = np.array([2, 0, 0, 0], "f4")
    g = tmoe.moe_balance_gauges(torch.from_numpy(load), 8, 1, publish=False)
    assert g == jmoe.moe_balance_gauges(load, 8, 1, publish=False)
    assert g == {"moe_expert_balance_ppm": 250000,
                 "moe_dropped_fraction_ppm": 750000}
    assert tmoe.moe_capacity(64, 4, 2, 1.25) == \
        jmoe.moe_capacity(64, 4, 2, 1.25) == 40


def _moe_case(s=20, seed=2):
    rs = np.random.RandomState(seed)
    return dict(X=[rs.randn(s, DM).astype("f4")],
                GateW=[rs.randn(DM, E).astype("f4")],
                W1=[(rs.randn(E, DM, FFN) / 4).astype("f4")],
                B1=[(rs.randn(E, FFN) / 10).astype("f4")],
                W2=[(rs.randn(E, FFN, DM) / 6).astype("f4")],
                B2=[(rs.randn(E, DM) / 10).astype("f4")])


OUTS = {"Out": 1, "AuxLoss": 1, "ExpertLoad": 1}
ATTRS = dict(num_experts=E, top_k=K, capacity_factor=1.25)


def test_moe_ffn_forward_and_gradients_match_jax():
    inputs = _moe_case()
    prog, feed, fetch = _program("torch", "moe_ffn", inputs, OUTS, ATTRS)
    probe = dict(zip(fetch, _run("torch", prog, feed, fetch)))
    rs = np.random.RandomState(7)
    cots = {n: rs.randn(*probe[n].shape).astype("f4")
            for n in ("out_out_0", "out_auxloss_0")}
    got = _run("torch", *_program("torch", "moe_ffn", inputs, OUTS, ATTRS,
                                  cots))
    want = _run("jax", *_program("jax", "moe_ffn", inputs, OUTS, ATTRS,
                                 cots))
    names = _program("torch", "moe_ffn", inputs, OUTS, ATTRS, cots)[2]
    assert len(names) == 3 + 6
    for n, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= 1e-5 * scale, (n, np.abs(g - w).max())
    grads = dict(zip(names, got))
    assert np.abs(grads["gatew_0@GRAD"]).max() > 0
    assert np.array_equal(grads["out_expertload_0"],
                          np.asarray(want[2]))


def test_router_gradient_reaches_gate_through_the_aux_loss():
    """With a zero cotangent on Out, GateW's gradient is the aux loss's:
    nonzero through P_e, equal to JAX's."""
    inputs = _moe_case(seed=3)
    cots = {"out_out_0": np.zeros((20, DM), "f4"),
            "out_auxloss_0": np.ones(1, "f4")}
    res = [dict(zip(_program(w, "moe_ffn", inputs, OUTS, ATTRS, cots)[2],
                    _run(w, *_program(w, "moe_ffn", inputs, OUTS, ATTRS,
                                      cots))))
           for w in ("torch", "jax")]
    g, w = res[0]["gatew_0@GRAD"], np.asarray(res[1]["gatew_0@GRAD"])
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert not np.asarray(res[0]["w1_0@GRAD"]).any()


def _moe_local(p):
    layers = p.layers
    main, startup = p.framework.Program(), p.framework.Program()
    main.random_seed = 1
    with p.framework.program_guard(main, startup):
        x = layers.data("x", [DM])
        y = layers.data("y", [1])
        h, aux, load = layers.moe_ffn(x, num_experts=E, ffn_dim=FFN,
                                      top_k=K, capacity_factor=1.25,
                                      name="moe0")
        pred = layers.fc(h, 1, name="head")
        loss = layers.elementwise_add(
            layers.mean(layers.square_error_cost(pred, y)),
            layers.scale(aux, 0.01))
        p.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
    return main, startup, [loss, load]


def _moe_feed(seed=0, n=32):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, DM).astype("f4")
    return {"x": x, "y": (x.sum(axis=1, keepdims=True) * 0.3).astype("f4")}


def test_static_moe_local_steps_match_jax():
    (jm, js, _), (tm, ts, tf) = build_both(_moe_local)
    n0 = stat_get("moe_ffn_engaged")
    want, got, _js, _ts = run_both((jm, js), (tm, ts),
                                   [_moe_feed(i) for i in range(3)], tf)
    assert stat_get("moe_ffn_engaged") > n0
    for w, g in zip(want, got):
        np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
        assert np.array_equal(g[1], w[1])
    assert got[-1][0] < got[0][0]


@pytest.mark.parametrize("chunks", [4, 3])
def test_chunked_is_bit_equal_to_sequential(chunks):
    """Capacity 20 (S = 32, K 2, E 4, factor 1.25): 4 chunks divide it,
    3 fall back."""
    (_, _, _), (tm, ts, tf) = build_both(_moe_local)
    outs = {}
    for n in (0, chunks):
        T.set_flags({"FLAGS_moe_alltoall_chunks": n})
        try:
            c0, f0 = (stat_get("moe_alltoall_chunked"),
                      stat_get("moe_alltoall_fallback"))
            exe, scope = T.Executor(T.CPUPlace()), T.framework.Scope()
            exe.run(ts, scope=scope)
            outs[n] = [exe.run(tm, feed=_moe_feed(i), fetch_list=tf,
                               scope=scope)[0] for i in range(2)]
            moved = (stat_get("moe_alltoall_chunked") - c0,
                     stat_get("moe_alltoall_fallback") - f0)
        finally:
            T.set_flags({"FLAGS_moe_alltoall_chunks": 0})
        if n == 4:
            assert moved[0] > 0 and moved[1] == 0
        elif n == 3:
            assert moved[0] == 0 and moved[1] > 0
    for a, b in zip(outs[0], outs[chunks]):
        assert np.array_equal(a, b)


def test_expert_parallel_stamp_raises_naming_item_8():
    inputs = _moe_case()
    prog, feed, fetch = _program("torch", "moe_ffn", inputs, OUTS,
                                 dict(ATTRS, __moe_ep__=2))
    with pytest.raises(NotImplementedError, match="item 8"):
        _run("torch", prog, feed, fetch)
