"""The dygraph functions of the JAX package's ``tests/test_dy2static.py``,
written once against either package (``P`` is ``paddle_tpu`` or
``paddle_tpu_torch``), for ``test_torch_dy2static*.py``.

``cases(P)`` maps a case name to ``(fn, inputs, rtol)``: the traced
function (or Layer), the numpy inputs (the first is the one traced), and
the tolerance each traced run is held to against eager dygraph.  Every
value is a float32 sum or product of powers of two and small integers,
exact in both packages, so ``rtol`` is 0 except where the JAX test set
one (1e-5, two doubling chains of different lengths).
"""
import numpy as np


def full(shape, v):
    return np.full(shape, v, "f4")


def cases(P):
    def branch(x):
        if x.mean() > 0:
            y = x * 2.0 + 1.0
        else:
            y = -x
        return y

    def if_return(x):
        if x.sum() > 0:
            return x + 10.0
        else:
            return x - 10.0

    def while_trips(x):
        # double until the sum crosses 100: trip count depends on data
        while x.sum() < 100.0:
            x = x * 2.0
        return x

    def for_break(x):
        acc = x * 0.0
        for i in range(10):
            acc = acc + x
            if acc.sum() > 50.0:
                break
        return acc

    def bool_ops(x):
        if (x.mean() > 0) and (x.sum() < 10.0):
            y = x + 1.0
        else:
            y = x - 1.0
        if not (x.mean() > 0):
            y = y * 3.0
        return y

    def python_flow(x, n=3):
        for _ in range(n):
            x = x + 1.0
        if n > 2:
            x = x * 2.0
        return x

    def nested_if(x):
        if x.mean() > 0:
            if x.sum() > 10.0:
                y = x * 2.0
            else:
                y = x * 3.0
        else:
            y = -x
        return y

    def break_index(x):
        k = x * 0.0
        for i in range(10):
            k = k + x
            if k.sum() > 50.0:
                break
        return k + i

    def two_breaks(x):
        acc = x * 0.0
        for _ in range(6):
            acc = acc + x
            if acc.sum() > 100.0:
                break
            acc = acc + x
            if acc.sum() > 50.0:
                break
            acc = acc + 1.0
        return acc

    def early_return(x):
        if x.mean() > 0:
            return x
        x = x * 2.0
        return x

    def return_in_while(x):
        while x.sum() < 100.0:
            x = x * 2.0
            if x.mean() > 20.0:
                return x - 1.0
        return x + 0.5

    def return_in_for(x):
        acc = x * 0.0
        for i in range(10):
            acc = acc + x
            if acc.sum() > 50.0:
                return acc * 10.0
        return acc

    def after_returning_loop(x):
        for i in range(4):
            x = x + 1.0
            if x.mean() > 3.0:
                return x * 100.0
        x = x - 0.25
        return x

    def rows_append(x):
        rows = []
        for r in x:
            if r.sum() > 0:
                rows.append(r * 2.0)
            else:
                rows.append(r - 1.0)
        return P.tensor.stack(rows)

    def guard_return(x, b=None):
        if b is None:
            return x * 2.0
        return x + b

    class Hooked(P.nn.Layer):
        def forward(self, x):
            if x.mean() > 0:
                return x * 2.0
            else:
                return -x

    hooked = Hooked()
    hooked.register_forward_post_hook(lambda l, i, o: o + 100.0)

    def zero_trip(x, n=0):
        k = x * 5.0
        for _ in range(n):
            k = k + 1.0
        return k

    def return_in_loop(x):
        acc = x * 0.0
        for i in range(3):
            acc = acc + x
            if acc.sum() > 1.0:
                return acc
        return acc

    def container_break(x):
        acc = x * 0.0
        for w in [1.0, 2.0, 3.0]:
            acc = acc + x * w
            if float(acc.numpy().sum()) > 4.0:
                break
        return acc

    def container_break_ifs(x):
        acc = x * 0.0
        for w in [1.0, 2.0, 3.0]:
            if acc.mean() > 0.5:
                acc = acc + x * w
            else:
                acc = acc + x * (2.0 * w)
            if float(acc.numpy().sum()) > 100.0:
                break
        return acc

    def return_nested_loop(x):
        for i in range(3):
            while x.sum() < 50.0:
                x = x * 2.0
                if x.mean() > 8.0:
                    return x + 100.0
            x = x + 1.0
        return x

    def return_both_arms(x):
        for i in range(4):
            x = x + 1.0
            if x.mean() > 3.0:
                if x.sum() > 20.0:
                    return x * 10.0
                else:
                    return x * -1.0
        return x

    return {
        "if_both_branches": (branch, [np.ones((2, 3), "f4"),
                                      -np.ones((2, 3), "f4")], 0.0),
        "if_return_form": (if_return, [full((2,), 1.0),
                                       full((2,), -1.0)], 0.0),
        "while_data_dependent_trip_count": (
            while_trips, [full((4,), v) for v in (1.0, 30.0, 99.0)], 0.0),
        "for_range_with_break": (for_break, [full((2,), 1.0),
                                             full((2,), 30.0)], 0.0),
        "bool_ops_and_not": (bool_ops, [full((2,), v)
                                        for v in (1.0, 20.0, -1.0)], 0.0),
        "python_control_flow_stays_python": (
            python_flow, [np.zeros((2,), "f4")], 0.0),
        "nested_if_converts": (nested_if, [full((2,), v)
                                           for v in (10.0, 1.0, -1.0)], 0.0),
        "break_leaves_loop_var_at_breaking_index": (
            break_index, [full((2,), 1.0), full((2,), 30.0)], 0.0),
        "two_break_sites_nested_guards": (
            two_breaks, [full((2,), v) for v in (1.0, 20.0, 60.0)], 0.0),
        "early_return_tensor_cond_converts": (
            early_return, [np.ones((2,), "f4"), full((2,), -1.0)], 0.0),
        "return_inside_while_loop": (
            return_in_while, [full((4,), v) for v in (1.0, 30.0, 99.0)],
            0.0),
        "return_inside_for_range_loop": (
            return_in_for, [full((2,), v) for v in (1.0, 30.0)], 0.0),
        "statements_after_returning_loop_are_guarded": (
            after_returning_loop, [full((2,), v) for v in (0.0, 5.0)], 0.0),
        "for_over_tensor_rows_with_list_append": (
            rows_append, [np.array([[1.0, 2.0], [-3.0, 1.0], [0.5, -2.0]],
                                   "f4")], 0.0),
        "python_guard_early_return_still_traces": (
            guard_return, [np.ones((2,), "f4")], 0.0),
        "layer_forward_hooks_survive_conversion": (
            hooked, [np.ones((2,), "f4"), full((2,), -1.0)], 0.0),
        "zero_trip_range_keeps_existing_var": (
            zero_trip, [np.ones((2,), "f4")], 0.0),
        "return_inside_loop_converts": (
            return_in_loop, [full((2,), v) for v in (1.0, 0.1)], 0.0),
        "container_for_with_break_stays_python": (
            container_break, [np.ones((2,), "f4")], 0.0),
        "container_for_break_still_converts_tensor_ifs": (
            container_break_ifs, [full((2,), v) for v in (1.0, -1.0)], 0.0),
        "return_inside_nested_loop": (
            return_nested_loop, [full((4,), v) for v in (1.0, 30.0, 60.0)],
            1e-5),
        "return_in_both_arms_inside_loop": (
            return_both_arms, [full((4,), v) for v in (0.0, 3.0, 9.0)],
            1e-5),
    }


def block_op_types(program):
    """Op types block by block: the program's structure."""
    return [[op.type for op in b.ops] for b in program.blocks]
