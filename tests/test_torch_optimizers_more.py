"""PyTorch port: the update lowerings ``lamb``, ``adagrad``, ``adamax``,
``adadelta`` and ``rmsprop`` (``ops/optimizer_ops.py``) against the JAX
package's, on the CPU, through the optimizers that emit them.

- Dygraph: ``Lamb``, ``Adagrad``, ``Adamax`` and ``RMSProp`` (plain,
  with momentum, centered) step a small network built by both packages,
  the JAX weights carried across by ``state_dict``; after 3 steps every
  parameter within 1e-5 of its tensor's largest magnitude (float32 both
  sides, other summation orders), and the optimizer states hold the same
  accumulators for each parameter.
- Static: the same optimizers' program builders (and ``Adadelta``'s)
  ``minimize`` a small fc program in each package; the port's executor
  runs it from the JAX startup's values, 3 steps: losses within 1e-5
  relative, every persistable (parameters and accumulators) within 1e-5
  of its tensor's largest magnitude.
"""
import numpy as np
import pytest

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, pair, to_numpy)

import paddle_tpu as jpkg
import paddle_tpu_torch as tpkg
from paddle_tpu.framework import unique_name as junique
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import scope_from_numpy

RTOL = 1e-5
rs = np.random.RandomState(11)
VEC = rs.randn(6, 5).astype("f4")
LABEL = rs.randint(0, 3, (6, 1)).astype("int64")

DYGRAPH = {
    "lamb": lambda p, ps: p.optimizer.Lamb(0.02, lamb_weight_decay=0.01,
                                           parameters=ps),
    "lamb_exclude": lambda p, ps: p.optimizer.Lamb(
        0.02, parameters=ps,
        exclude_from_weight_decay_fn=lambda prm: prm.name.endswith("b_0")),
    "adagrad": lambda p, ps: p.optimizer.Adagrad(0.1, parameters=ps,
                                                 initial_accumulator_value=0.1),
    "adamax": lambda p, ps: p.optimizer.Adamax(0.05, parameters=ps),
    "rmsprop": lambda p, ps: p.optimizer.RMSProp(0.01, parameters=ps),
    "rmsprop_momentum_centered": lambda p, ps: p.optimizer.RMSProp(
        0.01, momentum=0.9, centered=True, parameters=ps),
}


def _net(p):
    p.seed(4)
    return p.nn.Sequential(p.nn.Linear(5, 7), p.nn.Tanh(), p.nn.Linear(7, 3))


@pytest.mark.parametrize("name", sorted(DYGRAPH))
def test_dygraph_steps_match_jax(name):
    jn, tn = pair(_net)
    jo = DYGRAPH[name](J, jn.parameters())
    to = DYGRAPH[name](T, tn.parameters())
    for _ in range(3):
        for p, net, opt in ((J, jn, jo), (T, tn, to)):
            loss = p.nn.functional.cross_entropy(net(p.to_tensor(VEC)),
                                                 p.to_tensor(LABEL))
            loss.backward()
            opt.step()
            opt.clear_grad()
    for (n, a), (_, b) in zip(jn.named_parameters(), tn.named_parameters()):
        assert_close(to_numpy(a), to_numpy(b), RTOL, n)
        assert b._value.is_leaf
    assert _slots(to, tn) == _slots(jo, jn)


def _slots(opt, net):
    """The optimizer state's accumulator names, parameter by parameter
    (the parameters' own names differ between the packages)."""
    sd = opt.state_dict()
    return [sorted(k[len(p.name) + 1:] for k in sd
                   if k.startswith(p.name + "_")) for p in net.parameters()]


STATIC = {
    "lamb": lambda p: p.optimizer.Lamb(0.02, lamb_weight_decay=0.01),
    "adagrad": lambda p: p.optimizer.Adagrad(0.1),
    "adamax": lambda p: p.optimizer.Adamax(0.05),
    "adadelta": lambda p: p.optimizer.AdadeltaOptimizer(1.0, rho=0.9),
    "rmsprop_centered": lambda p: p.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True),
}


def _program(p, unique, make_opt):
    main, startup = p.framework.Program(), p.framework.Program()
    with unique.guard(), p.framework.program_guard(main, startup):
        x = p.layers.data("x", [5])
        y = p.layers.data("y", [1], dtype="int64")
        h = p.layers.fc(x, 7, act="tanh")
        loss = p.layers.mean(p.layers.softmax_with_cross_entropy(
            p.layers.fc(h, 3), y))
        make_opt(p).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("name", sorted(STATIC))
def test_static_programs_match_jax(name):
    jmain, jstart, jloss = _program(jpkg, junique, STATIC[name])
    tmain, _, tloss = _program(tpkg, tunique, STATIC[name])
    assert [op.type for op in tmain.global_block.ops] == \
        [op.type for op in jmain.global_block.ops]
    jscope = jpkg.framework.Scope()
    jexe = jpkg.Executor(jpkg.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.get_var(v.name))
            for v in jstart.global_block.vars.values() if v.persistable}
    tscope = scope_from_numpy(init, device="cpu")
    texe = tpkg.Executor(tpkg.CPUPlace())
    feed = {"x": VEC, "y": LABEL}
    for _ in range(3):
        want = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)[0]
        got = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)[0]
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)
    for n in init:
        assert_close(np.asarray(jscope.get_var(n)),
                     tscope.get_var(n).numpy(), RTOL, n)
