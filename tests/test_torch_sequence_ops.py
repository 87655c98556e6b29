"""PyTorch port: the dense sequence ops of ``ops/sequence_ops.py``
(``sequence_pool`` of each type, ``sequence_softmax``,
``sequence_reverse``, ``sequence_concat``, ``sequence_reshape``,
``sequence_expand`` / ``sequence_expand_as``, ``sequence_pad`` /
``sequence_unpad``, ``sequence_slice``, ``sequence_enumerate``,
``sequence_mask``, ``sequence_conv`` and ``row_conv``), each against the
JAX lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every float input gradient compared
(``test_torch_lowerings.check_case``); each op's cases run in one test.
The edge cases: tied maxima in ``sequence_pool`` (``jnp.max`` splits a
tie's gradient evenly, and so does ``amax``; ``MaxIndex`` is the first
maximum), lengths 0, 1 and T, a ``padded_length`` under T (no crop) and
a NaN in a padded row (``x * mask + pad * (1 - mask)`` keeps it), the
2-D and 3-D axis rules of ``sequence_reverse`` / ``sequence_concat``,
and context windows that run past both ends.

``sequence_slice`` reads its offset and length on the host, which the JAX
executor's jit cannot do: its JAX lowering is called directly on
concrete arrays through a small context (``JaxCtx``), its gradient by
``jax.vjp`` through that call.

Tolerance: 1e-5 absolute plus 1e-5 relative (``test_torch_lowerings.TOL``):
float32 on both sides, sums in another order (``sequence_conv``'s
matmul); the copies, masks and ids are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_lowerings as tl
from paddle_tpu.framework import lowering as jlowering
from paddle_tpu_torch.framework import executor as texecutor
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _tied(rs, *shape):
    """Values on a coarse grid: most reductions see a repeated maximum."""
    return (rs.randint(0, 4, shape) / 4.0).astype("f4")


def _lengths(*v):
    return np.array(v, "int64")


def _cases():
    rs = np.random.RandomState(231)
    pools = [case("sequence_pool", dict(X=[randn(rs, 3, 5, 4)]), ["Out"],
                  dict(pooltype=p))
             for p in ("AVERAGE", "SUM", "SQRT", "LAST", "FIRST")]
    pools.append(case("sequence_pool", dict(X=[_tied(rs, 3, 6, 4)]),
                      ["Out", "MaxIndex"], dict(pooltype="MAX")))
    nan_x = randn(rs, 12, 3)
    nan_x[11, 1] = np.nan           # a padded row of the second sequence
    pad = [case("sequence_pad", dict(X=[randn(rs, 12, 3)],
                                     PadValue=[np.array([0.5], "f4")],
                                     Length=[_lengths(4, 0, 1)]),
                ["Out"], dict(padded_length=6)),
           # Length passes through; with it among the outputs the generic
           # gradient of either package finds no Length input
           case("sequence_pad", dict(X=[randn(rs, 6, 3)],
                                     PadValue=[np.array([0.5], "f4")],
                                     Length=[_lengths(2, 3)]),
                ["Out", "Length"], grad=[]),
           case("sequence_pad", dict(X=[randn(rs, 12, 2, 3)],
                                     PadValue=[randn(rs, 2, 3)],
                                     Length=[_lengths(2, 3)]),
                ["Out"], dict(padded_length=4)),
           # a padded_length under T does not crop
           case("sequence_pad", dict(X=[randn(rs, 12, 3)],
                                     PadValue=[np.array([-1.0], "f4")],
                                     Length=[_lengths(6, 2)]),
                ["Out"], dict(padded_length=3)),
           case("sequence_pad", dict(X=[nan_x],
                                     PadValue=[np.array([2.0], "f4")],
                                     Length=[_lengths(3, 6, 1, 0)]),
                ["Out"], dict(padded_length=-1))]
    return {
        "sequence_pool": pools,
        "sequence_softmax": [case("sequence_softmax",
                                  dict(X=[randn(rs, 2, 5, 3)]), ["Out"])],
        "sequence_reverse": [
            case("sequence_reverse", dict(X=[randn(rs, 2, 5, 3)]), ["Y"],
                 grad=["Y"]),
            case("sequence_reverse", dict(X=[randn(rs, 6, 4)]), ["Y"],
                 grad=["Y"])],
        "sequence_concat": [
            case("sequence_concat", dict(X=[randn(rs, 2, 3, 4),
                                            randn(rs, 2, 5, 4)]), ["Out"]),
            case("sequence_concat", dict(X=[randn(rs, 3, 4),
                                            randn(rs, 2, 4)]), ["Out"])],
        "sequence_reshape": [case("sequence_reshape",
                                  dict(X=[randn(rs, 6, 4)]), ["Out"],
                                  dict(new_dim=8))],
        "sequence_expand": [case("sequence_expand",
                                 dict(X=[randn(rs, 2, 3)],
                                      Y=[randn(rs, 6, 1)]), ["Out"],
                                 grad=["Out"])],
        "sequence_expand_as": [case("sequence_expand_as",
                                    dict(X=[randn(rs, 3, 2, 2)],
                                         Y=[randn(rs, 6, 5)]), ["Out"])],
        "sequence_pad": pad,
        "sequence_unpad": [
            case("sequence_unpad", dict(X=[randn(rs, 4, 5, 3)],
                                        Length=[_lengths(5, 0, 1, 3)]),
                 ["Out"]),
            case("sequence_unpad", dict(X=[randn(rs, 2, 4)],
                                        Length=[_lengths(4, 2)]), ["Out"])],
        "sequence_enumerate": [
            case("sequence_enumerate", dict(X=[rs.randint(
                0, 50, (7, 1)).astype("int64")]), ["Out"],
                dict(win_size=3, pad_value=-1), grad=[]),
            case("sequence_enumerate", dict(X=[rs.randint(
                0, 50, (4,)).astype("int64")]), ["Out"],
                dict(win_size=6, pad_value=0), grad=[])],
        "sequence_mask": [
            case("sequence_mask", dict(X=[_lengths(0, 1, 5, 7)]), ["Y"],
                 dict(maxlen=5), grad=[]),
            case("sequence_mask", dict(X=[_lengths(2, 3)]), ["Y"],
                 dict(maxlen=4, out_dtype=5), grad=[])],
        "sequence_conv": [
            case("sequence_conv", dict(X=[randn(rs, 7, 4)],
                                       Filter=[randn(rs, 12, 5)]), ["Out"],
                 dict(contextLength=3, contextStart=-1)),
            case("sequence_conv", dict(X=[randn(rs, 3, 2)],
                                       Filter=[randn(rs, 10, 3)]), ["Out"],
                 dict(contextLength=5, contextStart=-3))],
        "row_conv": [
            case("row_conv", dict(X=[randn(rs, 9, 4)],
                                  Filter=[randn(rs, 3, 4)]), ["Out"]),
            case("row_conv", dict(X=[randn(rs, 3, 2)],
                                  Filter=[randn(rs, 5, 2)]), ["Out"])],
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_lowering_matches_jax(name):
    for i, c in enumerate(CASES[name]):
        pairs = check_case(f"{name}_{i}", c)
        if "MaxIndex" in c["outs"]:
            assert pairs["out_maxindex"][0].dtype == np.int32


def test_sequence_pad_keeps_nan_and_pads_zero_lengths():
    """A NaN in a padded row stays NaN (a multiply, not a select); a row
    of length 0 is all pad value."""
    c = CASES["sequence_pad"][4]
    out = tl._run("torch", *tl._build("torch", c))[0]
    assert np.isnan(out[3, 2, 1]) and np.isnan(out).sum() == 1
    assert (out[3][~np.isnan(out[3])] == 2.0).all()


class JaxCtx:
    """The part of the JAX lowering context a host-reading lowering uses,
    over concrete arrays: ``in1`` and ``set_out``."""

    def __init__(self, values):
        self.values = values
        self.out = {}

    def in1(self, op, slot):
        names = op.inputs.get(slot, [])
        return self.values[names[0]] if names else None

    def set_out(self, op, slot, value):
        self.out[slot] = value


class JaxOp:
    def __init__(self, op_type, inputs, attrs):
        self.type = op_type
        self.inputs = {s: [s] for s in inputs}
        self.outputs = {}
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def jax_direct(op_type, inputs, attrs, out_slot, wrt):
    """The JAX lowering of ``op_type`` called on ``inputs`` (numpy), and
    the vjp of ``out_slot`` with respect to input ``wrt`` for the
    cotangent it returns: (out, fn(cot) -> grad)."""
    op = JaxOp(op_type, inputs, attrs)

    def run(v):
        ctx = JaxCtx({**{k: jnp.asarray(a) for k, a in inputs.items()},
                      wrt: v})
        jlowering.LOWERINGS[op_type](ctx, op)
        return ctx.out[out_slot]

    out, vjp = jax.vjp(run, jnp.asarray(inputs[wrt]))
    return np.asarray(out), lambda cot: np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("off,ln", [(0, 6), (2, 3), (5, 1)])
def test_sequence_slice_matches_the_jax_lowering_called_directly(off, ln):
    """The port's program (eager: ``shape_tensor``) against the JAX
    lowering called on concrete arrays, output and X's gradient."""
    rs = np.random.RandomState(off)
    x = randn(rs, 6, 3)
    ins = dict(X=[x], Offset=[np.array([off], "int64")],
               Length=[np.array([ln], "int64")])
    c = case("sequence_slice", ins, ["Out"])
    prog, _feed, _fetch = tl._build("torch", c)
    assert texecutor.capture_reason(prog)[0] == "shape_tensor"
    want, vjp = jax_direct("sequence_slice",
                           {k: v[0] for k, v in ins.items()}, {}, "Out", "X")
    cot = np.random.RandomState(1).randn(*want.shape).astype("f4")
    got_out, got_dx = tl._run("torch", *tl._build(
        "torch", c, {"out_out": cot}))[:2]
    np.testing.assert_array_equal(got_out, want)
    np.testing.assert_allclose(got_dx, vjp(cot), **tl.TOL)
    assert got_out.shape == (ln, 3)


@pytest.mark.parametrize("op_type,ins,attrs,message", [
    ("sequence_pad", dict(X=np.zeros((4, 2), "f4"),
                          PadValue=np.zeros(1, "f4")), {}, "Length"),
    ("sequence_mask", dict(X=np.array([1, 2], "int64")), {}, "maxlen"),
])
def test_refusals_match_jax(op_type, ins, attrs, message):
    """Without ``Length`` / a static ``maxlen`` both packages refuse."""
    c = case(op_type, {k: [v] for k, v in ins.items()},
             ["Out" if op_type == "sequence_pad" else "Y"], attrs, grad=[])
    for which in ("jax", "torch"):
        with pytest.raises(NotImplementedError, match=message):
            tl._run(which, *tl._build(which, c))
