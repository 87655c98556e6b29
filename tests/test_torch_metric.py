"""PyTorch port: ``paddle_tpu_torch.metric`` and the ``accuracy`` op
against the JAX package's, on the CPU.

- ``Accuracy`` (top-1, top-k), ``Precision``, ``Recall`` and ``Auc`` keep
  numpy state on the host in both packages: fed the same seeded batches
  (as numpy or as the port's tensors), every ``compute`` row, ``update``
  return and ``accumulate`` equals the JAX package's exactly.
- The functional ``accuracy`` runs the ``accuracy`` op
  (``ops/misc.py``) eagerly, and ``layers.accuracy`` in a static program
  through the executor; ``Accuracy``, ``Correct`` and ``Total`` equal the
  JAX package's (the share within 1e-7: one float32 division).
"""
import numpy as np
import pytest

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, to_numpy)

rs = np.random.RandomState(3)
BATCHES = [(rs.randn(6, 7).astype("f4"), rs.randint(0, 7, (6, 1)).astype("int64"))
           for _ in range(3)]


@pytest.mark.parametrize("topk", [1, (1, 5)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_accuracy_metric_equals_jax(topk, as_tensor):
    jm, tm = J.metric.Accuracy(topk=topk), T.metric.Accuracy(topk=topk)
    assert tm.name() == jm.name()
    for pred, label in BATCHES:
        tp, tl = (T.to_tensor(pred), T.to_tensor(label)) if as_tensor \
            else (pred, label)
        jc, tc = jm.compute(pred, label), tm.compute(tp, tl)
        np.testing.assert_array_equal(jc, tc)
        np.testing.assert_array_equal(jm.update(jc), tm.update(tc))
    assert tm.accumulate() == jm.accumulate()
    tm.reset()
    assert tm.accumulate() == (0.0 if topk == 1 else [0.0, 0.0])


def test_precision_recall_auc_equal_jax():
    probs = rs.rand(40).astype("f4")
    labels = (rs.rand(40) < probs).astype("int64")
    for cls, kw in (("Precision", {}), ("Recall", {}),
                    ("Auc", {"num_thresholds": 255})):
        jm, tm = getattr(J.metric, cls)(**kw), getattr(T.metric, cls)(**kw)
        for lo in range(0, 40, 10):
            jm.update(probs[lo:lo + 10], labels[lo:lo + 10])
            tm.update(T.to_tensor(probs[lo:lo + 10]), labels[lo:lo + 10])
        assert tm.accumulate() == jm.accumulate() and tm.name() == jm.name()
    two = np.stack([1 - probs, probs], 1)
    jm, tm = J.metric.Auc(), T.metric.Auc()
    jm.update(two, labels)
    tm.update(two, labels)
    assert tm.accumulate() == jm.accumulate()


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy_equals_jax(k):
    for pred, label in BATCHES:
        want = to_numpy(J.metric.accuracy(J.to_tensor(pred),
                                          J.to_tensor(label), k=k))
        got = to_numpy(T.metric.accuracy(T.to_tensor(pred),
                                         T.to_tensor(label), k=k))
        assert got.shape == want.shape == (1,)
        np.testing.assert_allclose(got, want, rtol=1e-7)


def _static_accuracy(p, place, k):
    main, startup = p.framework.Program(), p.framework.Program()
    with p.framework.program_guard(main, startup):
        x = p.layers.data("x", [7])
        y = p.layers.data("y", [1], dtype="int64")
        acc = p.layers.accuracy(x, y, k=k)
        op = main.global_block.ops[-1]
        fetch = [acc.name, op.output("Correct")[0], op.output("Total")[0]]
    exe = p.Executor(place)
    scope = p.framework.Scope()
    exe.run(startup, scope=scope)
    pred, label = BATCHES[0]
    return exe.run(main, feed={"x": pred, "y": label}, fetch_list=fetch,
                   scope=scope)


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_op_in_a_static_program_equals_jax(k):
    want = _static_accuracy(J, J.CPUPlace(), k)
    got = _static_accuracy(T, T.CPUPlace(), k)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-7)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
