"""Runs one case of ``torch_dy2static_cases`` in both packages: each
traces the function on the case's first input, the traced program runs
every input and is held to eager dygraph within the case's ``rtol``, and
the two packages' programs have the same op types, block by block."""
import numpy as np

import paddle_tpu as J
import paddle_tpu.dygraph.jit as jjit
import paddle_tpu_torch as T
import paddle_tpu_torch.dygraph.jit as tjit
from torch_dy2static_cases import block_op_types, cases

JIT = {J: jjit, T: tjit}


def run_case(name):
    seen = {}
    for P in (J, T):
        fn, inputs, rtol = cases(P)[name]
        with P.dygraph.guard():
            def tensor(a):
                return P.dygraph.to_variable(a.copy())

            eager = [np.asarray(fn(tensor(a)).numpy()) for a in inputs]
            _, tl = JIT[P].TracedLayer.trace(fn, [tensor(inputs[0])])
            for a, want in zip(inputs, eager):
                got = np.asarray(tl(tensor(a))[0].numpy())
                np.testing.assert_allclose(got, want, rtol=rtol)
        seen[P] = block_op_types(tl.program), eager
    assert seen[T][0] == seen[J][0]
    for t, j in zip(seen[T][1], seen[J][1]):
        np.testing.assert_allclose(t, j, rtol=1e-6)
    return seen[T][0]
