"""PyTorch port: the op lowerings that the unfused attention chain and the
graph passes add.

More cases of ``test_torch_lowerings.py``'s check (a one-op program and its
gradient op through both packages' executors on the CPU, every output and
every input gradient compared): ``matmul`` / ``matmul_v2``, ``softmax``,
``transpose2`` with its explicit ``transpose2_grad``, the ``assign`` that the
redundant-cast pass leaves, and the ``flash_attention`` op that
``FlashAttentionPass`` emits, on the plain composition and with B2-B4
engaged (the JAX side on its Pallas kernels in interpret mode, the port on
the kernels' plain versions).

Tolerance: that file's 1e-5 absolute plus 1e-5 relative in float32.  The
bfloat16 cases of ``matmul`` and ``softmax`` are held to one bfloat16 step
instead (2**-7 relative, 8 significant bits, plus 1e-3 absolute for sums that
cancel): both sides accumulate in float32 and round to bfloat16, at an order
of summation that can move a result across a rounding boundary.
"""
import ml_dtypes
import numpy as np
import pytest

from test_torch_lowerings import _case, _f, check_case

BF16_TOL = dict(atol=1e-3, rtol=2.0 ** -7)


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def _cases():
    rs = np.random.RandomState(3)
    mask = np.where(rs.rand(2, 1, 1, 128) < 0.1, -1e4, 0.0).astype("f4")
    # the unfused chain's operands, [B, H, S, D], and what the pass makes
    # of it
    heads = [_f(rs, 2, 2, 128, 64) * 0.5 for _ in range(3)]
    fa_in = dict(Q=[heads[0]], K=[heads[1]], V=[heads[2]], Mask=[mask])
    return {
        "matmul_qk": _case(
            "matmul", dict(X=[heads[0]], Y=[heads[1]]), ["Out"],
            dict(transpose_X=False, transpose_Y=True, alpha=0.125)),
        "matmul_transpose_x": _case(
            "matmul", dict(X=[_f(rs, 3, 5, 4)], Y=[_f(rs, 3, 5, 6)]),
            ["Out"], dict(transpose_X=True, transpose_Y=False, alpha=1.0)),
        "matmul_bfloat16": _case(
            "matmul", dict(X=[_bf16(heads[0])], Y=[_bf16(heads[1])]),
            ["Out"], dict(transpose_X=False, transpose_Y=True, alpha=0.125),
            tol=BF16_TOL),
        "matmul_v2": _case(
            "matmul_v2", dict(X=[_f(rs, 3, 4, 5)], Y=[_f(rs, 3, 6, 5)]),
            ["Out"], dict(trans_x=False, trans_y=True)),
        "softmax": _case(
            "softmax", dict(X=[_f(rs, 2, 2, 8, 16) * 3 + mask[:, :, :, :16]]),
            ["Out"], dict(axis=-1)),
        "softmax_axis1": _case(
            "softmax", dict(X=[_f(rs, 3, 7, 5)]), ["Out"], dict(axis=1)),
        "softmax_bfloat16": _case(
            "softmax", dict(X=[_bf16(_f(rs, 2, 2, 8, 16) * 3)]), ["Out"],
            dict(axis=-1), tol=BF16_TOL),
        "transpose2": _case(
            "transpose2", dict(X=[_f(rs, 2, 3, 4, 5)]), ["Out", "XShape"],
            dict(axis=[0, 2, 1, 3])),
        "transpose2_cyclic": _case(     # its inverse is not itself
            "transpose2", dict(X=[_f(rs, 2, 3, 4)]), ["Out", "XShape"],
            dict(axis=[2, 0, 1])),
        "transpose2_bfloat16": _case(
            "transpose2", dict(X=[_bf16(_f(rs, 2, 3, 4, 5))]),
            ["Out", "XShape"], dict(axis=[0, 2, 1, 3])),
        "assign": _case("assign", dict(X=[_f(rs, 3, 4)]), ["Out"]),
        "assign_bfloat16": _case(
            "assign", dict(X=[_bf16(_f(rs, 3, 4))]), ["Out"]),
        "flash_attention": _case(
            "flash_attention", fa_in, ["Out"],
            dict(scale=0.125, causal=False)),
        "flash_attention_causal_no_mask": _case(
            "flash_attention", {s: v for s, v in fa_in.items()
                                if s != "Mask"}, ["Out"],
            dict(scale=0.125, causal=True)),
        "flash_attention_kernels": _case(    # B2-B4 in both packages
            "flash_attention", fa_in, ["Out"],
            dict(scale=0.125, causal=False), flash=True),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_unfused_lowering_matches_jax(name):
    check_case(name, CASES[name])
