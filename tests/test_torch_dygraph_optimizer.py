"""PyTorch port: the 2.0 optimizers' dygraph ``step`` and the AMP
``GradScaler`` / ``decorate`` against the JAX package's, on the CPU.

A small network is built by both packages, the JAX one's weights carried
across, and trained 3 steps by each optimizer on the same batch: every
parameter within 1e-5 of its tensor's largest magnitude after them
(``torch_dygraph_parity``: float32 both sides, other summation orders),
each still the leaf it was.  An optimizer whose update op has no lowering
in the port yet raises at ``step``.  ``GradScaler.unscale_`` reads its
inf / NaN verdict with one host sync for all the gradients.
"""
import numpy as np
import pytest
import torch

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, pair, to_numpy)

rs = np.random.RandomState(8)
VEC = rs.randn(4, 6).astype("f4")


def _net(p):
    p.seed(0)
    return p.nn.Sequential(p.nn.Linear(6, 8), p.nn.Tanh(), p.nn.Linear(8, 3))


@pytest.mark.parametrize("make_opt", [
    lambda p, ps: p.optimizer.SGD(0.1, parameters=ps),
    lambda p, ps: p.optimizer.SGD(0.1, parameters=ps, weight_decay=0.01),
    lambda p, ps: p.optimizer.Momentum(0.1, 0.9, parameters=ps),
    lambda p, ps: p.optimizer.Momentum(0.05, 0.9, parameters=ps,
                                       use_nesterov=True, weight_decay=1e-3),
    lambda p, ps: p.optimizer.Adam(0.01, parameters=ps),
    lambda p, ps: p.optimizer.AdamW(0.01, parameters=ps, weight_decay=0.1,
                                    apply_decay_param_fun=lambda n: "b" not in n),
], ids=["sgd", "sgd_l2", "momentum", "momentum_nesterov_l2", "adam", "adamw"])
def test_optimizer_steps(make_opt):
    jn, tn = pair(_net)
    jo, to = make_opt(J, jn.parameters()), make_opt(T, tn.parameters())
    y = rs.randint(0, 3, (4, 1)).astype("int64")
    for _ in range(3):
        for p, net, opt in ((J, jn, jo), (T, tn, to)):
            loss = p.nn.functional.cross_entropy(net(p.to_tensor(VEC)),
                                                 p.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
    for (n, a), (_, b) in zip(jn.named_parameters(), tn.named_parameters()):
        assert_close(to_numpy(a), to_numpy(b), 1e-5, n)
        assert b._value.is_leaf and b.grad is None
    assert len(jo.state_dict()) == len(to.state_dict())


def test_optimizers_without_an_update_lowering_raise_at_step():
    """Lamb, Adagrad, Adamax and RMSProp have their update lowerings now
    (held to the JAX package in ``test_torch_optimizers_more.py``); an
    optimizer whose update op still has none (``lars_momentum``, a later
    slice) raises at ``step``, before any parameter moves."""
    class Lars(T.optimizer.Momentum):
        _op_type = "lars_momentum"

    net = _net(T)
    net(T.to_tensor(VEC)).sum().backward()
    before = [to_numpy(p) for p in net.parameters()]
    with pytest.raises(NotImplementedError, match="later slice"):
        Lars(0.1, parameters=net.parameters()).step()
    for a, p in zip(before, net.parameters()):
        np.testing.assert_array_equal(a, to_numpy(p))


def test_grad_scaler_one_sync_and_decorate(monkeypatch):
    def run(p, net):
        opt = p.optimizer.SGD(0.1, parameters=net.parameters())
        scaler = p.amp.GradScaler(init_loss_scaling=1024.0)
        loss = net(p.to_tensor(VEC)).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        return [to_numpy(q) for q in net.parameters()], scaler

    jn, tn = pair(_net)
    (jp_, js), (tp_, ts) = run(J, jn), run(T, tn)
    for a, b in zip(jp_, tp_):
        assert_close(a, b)
    assert js.get_loss_scaling() == ts.get_loss_scaling()
    net = _net(T)
    opt = T.optimizer.SGD(0.1, parameters=net.parameters())
    net(T.to_tensor(VEC)).sum().backward()
    net[0].weight._value.grad[0, 0] = float("inf")
    syncs = []
    real = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda t: syncs.append(1) or real(t))
    scaler = T.amp.GradScaler(init_loss_scaling=8.0,
                              decr_every_n_nan_or_inf=1)
    before = to_numpy(net[2].weight)
    scaler.step(opt)
    assert len(syncs) == 1 and scaler._found_inf
    np.testing.assert_array_equal(to_numpy(net[2].weight), before)
    assert scaler.get_loss_scaling() == 4.0
    monkeypatch.undo()
    m = T.amp.decorate(models=_net(T), level="O2", dtype="bfloat16")
    assert all(q.dtype == torch.bfloat16 for q in m.parameters())
