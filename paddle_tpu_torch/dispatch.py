"""Dual-mode op dispatch for the 2.0 API.

Counterpart of ``paddle_tpu/dispatch.py``, unchanged but for its eager
branch, which runs the port's ``dygraph.eager.run_op`` on torch tensors.

Role parity: the reference 2.0 API functions each contain
``if in_dygraph_mode(): return core.ops.xxx(...)`` followed by a
LayerHelper/append_op static branch (e.g. python/paddle/tensor/math.py).
Here that pattern is one helper: eager inputs run the lowering rule now
(dygraph/eager.py); graph Variables append an IR op that the executor
lowers when the program runs.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .framework.program import Variable
from .layer_helper import LayerHelper


def _is_eager(x) -> bool:
    from .dygraph.tensor import Tensor

    return isinstance(x, Tensor)


def _any_static(inputs: Dict) -> bool:
    for v in inputs.values():
        if v is None:
            continue
        vs = v if isinstance(v, (list, tuple)) else [v]
        for x in vs:
            if isinstance(x, Variable):
                return True
    return False


def _any_eager(inputs: Dict) -> bool:
    for v in inputs.values():
        if v is None:
            continue
        vs = v if isinstance(v, (list, tuple)) else [v]
        for x in vs:
            if _is_eager(x):
                return True
    return False


def in_dygraph_mode() -> bool:
    from .dygraph.base import in_dygraph_mode as _m

    return _m()


def op_call(op_type: str, inputs: Dict, attrs: Optional[dict] = None,
            outs: Sequence[str] = ("Out",), dtype=None, name: Optional[str] = None,
            out_counts: Optional[Dict[str, int]] = None):
    """Run/append one op; returns a value per out slot (single value if one).

    Mode resolution: eager inputs -> eager; Variables -> static graph;
    neither (e.g. creation ops) -> static if paddle.enable_static() was
    called OR we are inside a program_guard block, else eager.
    """
    from .framework.program import in_program_guard

    static = _any_static(inputs) or (
        not _any_eager(inputs) and (not in_dygraph_mode() or in_program_guard()))
    if not static:
        from .dygraph.eager import run_op

        res = run_op(op_type, inputs, attrs, out_slots=tuple(outs),
                     out_counts=out_counts)
        vals = [res.get(s) for s in outs]
        return vals[0] if len(outs) == 1 else tuple(vals)

    helper = LayerHelper(name or op_type)
    in_names = {}
    for slot, v in inputs.items():
        if v is None:
            continue
        vs = v if isinstance(v, (list, tuple)) else [v]
        names = []
        for x in vs:
            if isinstance(x, Variable):
                names.append(x.name)
            else:
                # inline constant: materialize through fill/assign
                names.append(_const_to_var(helper, x).name)
        in_names[slot] = names

    out_vars = {}
    first_dtype = dtype
    if first_dtype is None:
        for slot, v in inputs.items():
            vs = v if isinstance(v, (list, tuple)) else ([v] if v is not None else [])
            for x in vs:
                if isinstance(x, Variable):
                    first_dtype = x.dtype
                    break
            if first_dtype is not None:
                break
    for slot in outs:
        n = (out_counts or {}).get(slot, 1)
        vars_ = [helper.create_variable_for_type_inference(first_dtype or "float32")
                 for _ in range(n)]
        out_vars[slot] = vars_

    helper.append_op(op_type, in_names,
                     {s: [v.name for v in vs] for s, vs in out_vars.items()},
                     attrs or {})
    vals = []
    for slot in outs:
        vs = out_vars[slot]
        n = (out_counts or {}).get(slot)
        vals.append(vs if n is not None else vs[0])
    return vals[0] if len(outs) == 1 else tuple(vals)


def _const_to_var(helper: LayerHelper, x) -> Variable:
    from .framework import dtypes

    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    out = helper.create_variable_for_type_inference(str(arr.dtype))
    if arr.ndim == 0:
        helper.append_op("fill_constant", {}, {"Out": out},
                         {"shape": [1], "dtype": dtypes.to_enum(str(arr.dtype)),
                          "value": float(arr)})
    else:
        key = {"float32": "fp32_values", "int32": "int32_values",
               "int64": "int64_values", "bool": "bool_values"}.get(str(arr.dtype), "fp32_values")
        helper.append_op("assign_value", {}, {"Out": out},
                         {"shape": list(arr.shape), "dtype": dtypes.to_enum(str(arr.dtype)),
                          key: arr.ravel().tolist()})
    return out
