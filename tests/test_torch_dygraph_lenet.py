"""PyTorch port: dygraph LeNet (``vision/models/lenet.py``) trained
against the JAX package's dygraph, on the CPU: built once by each
package, the JAX weights carried across, 3 steps of
``optimizer.Momentum(0.1, 0.9)`` on one seeded batch of 2 at 1x28x28;
losses within 1e-4 relative and every parameter within 1e-4 of its
tensor's largest magnitude (float32 both sides in other summation
orders; measured about 1e-6).  Then ``Model.eval`` inference agrees, and
the port's parameters are still the leaves the optimizer was given.
"""
import numpy as np

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, check, pair, to_numpy)

RTOL = 1e-4


def test_lenet_trains_like_jax():
    J.seed(1)
    jm, tm = pair(lambda p: p.vision.models.LeNet())
    leaves = [p._value for p in tm.parameters()]
    rs = np.random.RandomState(3)
    x = rs.randn(2, 1, 28, 28).astype("f4")
    y = rs.randint(0, 10, (2, 1)).astype("int64")
    jo = J.optimizer.Momentum(0.1, 0.9, parameters=jm.parameters())
    to = T.optimizer.Momentum(0.1, 0.9, parameters=tm.parameters())
    losses = {J: [], T: []}
    for _ in range(3):
        for p, m, o in ((J, jm, jo), (T, tm, to)):
            loss = p.nn.functional.cross_entropy(m(p.to_tensor(x)),
                                                 p.to_tensor(y))
            loss.backward()
            o.step()
            o.clear_grad()
            losses[p].append(float(loss))
    np.testing.assert_allclose(losses[T], losses[J], rtol=RTOL)
    for (n, a), (_, b) in zip(jm.named_parameters(), tm.named_parameters()):
        assert_close(to_numpy(a), to_numpy(b), RTOL, n)
    assert all(p._value is v for p, v in zip(tm.parameters(), leaves))
    jm.eval(), tm.eval()
    check(jm, tm, x, grad=False, rtol=RTOL)
