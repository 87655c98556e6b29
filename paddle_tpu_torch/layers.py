"""Declarative layer functions — build ops into the default main program.

Copy of ``paddle_tpu/layers.py`` (the JAX package's module imports no
JAX); the program it builds is the same, op for op.

Role parity: reference python/paddle/fluid/layers/ (nn.py 15.2k LoC,
tensor.py, loss.py).  Each function creates vars + one or more OpDescs;
execution happens when the Executor runs the block's lowerings.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .framework import dtypes
from .framework.program import Variable, default_main_program
from .initializer import ConstantInitializer, NormalInitializer
from .layer_helper import LayerHelper

__all__ = [
    "data",
    "fc",
    "conv2d",
    "pool2d",
    "batch_norm",
    "layer_norm",
    "embedding",
    "dropout",
    "relu",
    "sigmoid",
    "tanh",
    "gelu",
    "leaky_relu",
    "softmax",
    "log_softmax",
    "softmax_with_cross_entropy",
    "cross_entropy",
    "square_error_cost",
    "mean",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "accuracy",
    "topk",
    "argmax",
    "concat",
    "split",
    "reshape",
    "transpose",
    "flatten",
    "squeeze",
    "unsqueeze",
    "stack",
    "cast",
    "fill_constant",
    "assign",
    "zeros",
    "ones",
    "zeros_like",
    "ones_like",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "mul",
    "matmul",
    "fused_multihead_attention",
    "moe_ffn",
    "scale",
    "clip",
    "clip_by_norm",
    "sqrt",
    "square",
    "abs",
    "exp",
    "log",
    "pow",
    "sum",
    "one_hot",
    "slice",
    "gather",
    "gather_nd",
    "scatter",
    "expand",
    "uniform_random",
    "gaussian_random",
    "dropout",
    "pad",
    "where",
    "equal",
    "not_equal",
    "less_than",
    "less_equal",
    "greater_than",
    "greater_equal",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "logical_and",
    "logical_not",
    "increment",
    "cumsum",
    "shape",
]


def _to_var(x, helper: LayerHelper, dtype="float32"):
    """Promote python scalars / numpy arrays to program vars."""
    if isinstance(x, Variable):
        return x
    arr = np.asarray(x)
    out = helper.create_variable_for_type_inference(str(arr.dtype), stop_gradient=True)
    out.shape = tuple(arr.shape)
    helper.append_op(
        "assign_value",
        {},
        {"Out": out},
        {
            "shape": list(arr.shape) or [1],
            "dtype": dtypes.to_enum(str(arr.dtype)),
            (
                "int32_values"
                if arr.dtype.kind == "i" and arr.dtype.itemsize <= 4
                else "int64_values"
                if arr.dtype.kind == "i"
                else "bool_values"
                if arr.dtype.kind == "b"
                else "fp32_values"
            ): arr.ravel().tolist(),
        },
    )
    return out


def _infer_unary_shape(x):
    return tuple(x.shape)


def _conv_hw(h, k, s, p, d=1):
    if h < 0:
        return -1
    return (h + 2 * p - (d * (k - 1) + 1)) // s + 1


def data(name, shape, dtype="float32", append_batch_size=True, lod_level=0):
    """Declare a feed slot (reference fluid.layers.data / fluid.data)."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block
    var = block.create_var(
        name=name, shape=shape, dtype=dtype, stop_gradient=True
    )
    return var


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("fc", name=name)
    in_dim = 1
    for s in input.shape[num_flatten_dims:]:
        in_dim *= int(s)
    w = helper.create_parameter(param_attr, [in_dim, size], dtype=input.dtype_str)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    out.shape = tuple(input.shape[:num_flatten_dims]) + (size,)
    helper.append_op(
        "mul",
        {"X": input, "Y": w},
        {"Out": out},
        {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], dtype=input.dtype_str, is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype_str)
        out2.shape = out.shape
        helper.append_op(
            "elementwise_add", {"X": out, "Y": b}, {"Out": out2}, {"axis": num_flatten_dims}
        )
        out = out2
    return helper.append_activation(out, act)


def moe_ffn(input, num_experts, ffn_dim=None, top_k=2,
            capacity_factor=1.25, param_attr=None, bias_attr=None,
            gate_attr=None, name=None):
    """Mixture-of-experts routed FFN (ops/moe_ops.py): top-k routing
    with capacity-factor dispatch over ``num_experts`` stacked expert
    FFNs.  Returns ``(out, aux_loss, expert_load)`` — add ``aux_loss``
    (Switch load-balance loss) into the training loss; ``expert_load``
    is the per-expert kept-token count gauge (stop-gradient)."""
    helper = LayerHelper("moe_ffn", name=name)
    d = int(input.shape[-1])
    h = int(ffn_dim or 4 * d)
    e = int(num_experts)
    gate_w = helper.create_parameter(
        gate_attr, [d, e], dtype=input.dtype_str,
        default_initializer=NormalInitializer(0.0, 0.02))
    w1 = helper.create_parameter(param_attr, [e, d, h],
                                 dtype=input.dtype_str)
    b1 = helper.create_parameter(bias_attr, [e, h],
                                 dtype=input.dtype_str, is_bias=True)
    w2 = helper.create_parameter(param_attr, [e, h, d],
                                 dtype=input.dtype_str)
    b2 = helper.create_parameter(bias_attr, [e, d],
                                 dtype=input.dtype_str, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    out.shape = tuple(input.shape)
    aux = helper.create_variable_for_type_inference("float32")
    aux.shape = (1,)
    load = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    load.shape = (e,)
    helper.append_op(
        "moe_ffn",
        {"X": input, "GateW": gate_w, "W1": w1, "B1": b1,
         "W2": w2, "B2": b2},
        {"Out": out, "AuxLoss": aux, "ExpertLoad": load},
        {"num_experts": e, "top_k": int(top_k),
         "capacity_factor": float(capacity_factor)},
    )
    return out, aux, load


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
    data_format="NCHW",
):
    helper = LayerHelper("conv2d", name=name)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) else list(dilation)
    c_in = int(input.shape[1] if data_format == "NCHW" else input.shape[-1])
    w_shape = [num_filters, c_in // groups] + list(filter_size)
    fan_in = (c_in // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        param_attr,
        w_shape,
        dtype=input.dtype_str,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5),
    )
    out = helper.create_variable_for_type_inference(input.dtype_str)
    if len(input.shape) == 4:
        n, _, h, wd = (
            input.shape if data_format == "NCHW" else (input.shape[0], input.shape[3], input.shape[1], input.shape[2])
        )
        oh = _conv_hw(h, filter_size[0], stride[0], padding[0], dilation[0])
        ow = _conv_hw(wd, filter_size[1], stride[1], padding[1], dilation[1])
        out.shape = (n, num_filters, oh, ow) if data_format == "NCHW" else (n, oh, ow, num_filters)
    helper.append_op(
        "conv2d",
        {"Input": input, "Filter": w},
        {"Output": out},
        {
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
            "data_format": data_format,
        },
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], dtype=input.dtype_str, is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype_str)
        out2.shape = tuple(out.shape)
        helper.append_op(
            "elementwise_add",
            {"X": out, "Y": b},
            {"Out": out2},
            {"axis": 1 if data_format == "NCHW" else -1},
        )
        out = out2
    return helper.append_activation(out, act)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    ceil_mode=False,
    exclusive=True,
    name=None,
    data_format="NCHW",
):
    helper = LayerHelper("pool2d", name=name)
    pool_size = [pool_size] * 2 if isinstance(pool_size, int) else list(pool_size)
    pool_stride = [pool_stride] * 2 if isinstance(pool_stride, int) else list(pool_stride)
    pool_padding = [pool_padding] * 2 if isinstance(pool_padding, int) else list(pool_padding)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    if len(input.shape) == 4:
        n, c, h, wd = (
            input.shape if data_format == "NCHW" else (input.shape[0], input.shape[3], input.shape[1], input.shape[2])
        )
        if global_pooling:
            oh = ow = 1
        else:
            oh = _conv_hw(h, pool_size[0], pool_stride[0], pool_padding[0])
            ow = _conv_hw(wd, pool_size[1], pool_stride[1], pool_padding[1])
        out.shape = (n, c, oh, ow) if data_format == "NCHW" else (n, oh, ow, c)
    helper.append_op(
        "pool2d",
        {"X": input},
        {"Out": out},
        {
            "pooling_type": pool_type,
            "ksize": pool_size,
            "strides": pool_stride,
            "paddings": pool_padding,
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
            "data_format": data_format,
        },
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    use_global_stats=False,
):
    helper = LayerHelper("batch_norm", name=name)
    c = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    scale = helper.create_parameter(
        param_attr, [c], dtype=input.dtype_str, default_initializer=ConstantInitializer(1.0)
    )
    bias = helper.create_parameter(bias_attr, [c], dtype=input.dtype_str, is_bias=True)
    mean = helper.create_global_variable(
        [c], dtype=input.dtype_str, name=moving_mean_name, initializer=ConstantInitializer(0.0)
    )
    variance = helper.create_global_variable(
        [c], dtype=input.dtype_str, name=moving_variance_name, initializer=ConstantInitializer(1.0)
    )
    out = helper.create_variable_for_type_inference(input.dtype_str)
    out.shape = tuple(input.shape)
    saved_mean = helper.create_variable_for_type_inference(input.dtype_str, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(input.dtype_str, stop_gradient=True)
    helper.append_op(
        "batch_norm",
        {"X": input, "Scale": scale, "Bias": bias, "Mean": mean, "Variance": variance},
        {
            "Y": out,
            "MeanOut": mean,
            "VarianceOut": variance,
            "SavedMean": saved_mean,
            "SavedVariance": saved_var,
        },
        {
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        },
    )
    return helper.append_activation(out, act)


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper("layer_norm", name=name)
    norm_dim = 1
    for s in input.shape[begin_norm_axis:]:
        norm_dim *= int(s)
    inputs = {"X": input}
    if scale:
        s_p = helper.create_parameter(
            param_attr, [norm_dim], dtype=input.dtype_str, default_initializer=ConstantInitializer(1.0)
        )
        inputs["Scale"] = s_p
    if shift:
        b_p = helper.create_parameter(bias_attr, [norm_dim], dtype=input.dtype_str, is_bias=True)
        inputs["Bias"] = b_p
    out = helper.create_variable_for_type_inference(input.dtype_str)
    out.shape = tuple(input.shape)
    mean = helper.create_variable_for_type_inference(input.dtype_str, stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype_str, stop_gradient=True)
    helper.append_op(
        "layer_norm",
        inputs,
        {"Y": out, "Mean": mean, "Variance": var},
        {"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out, act)


def embedding(
    input,
    size,
    is_sparse=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
    name=None,
):
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(input.shape) + (int(size[1]),)
    helper.append_op(
        "lookup_table_v2",
        {"W": w, "Ids": input},
        {"Out": out},
        {"padding_idx": -1 if padding_idx is None else padding_idx,
         "is_sparse": bool(is_sparse)},
    )
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None, dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    out.shape = tuple(x.shape)
    mask = helper.create_variable_for_type_inference("uint8", stop_gradient=True)
    helper.append_op(
        "dropout",
        {"X": x},
        {"Out": out, "Mask": mask},
        {
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed or 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


# ---------------------------------------------------------------------------
# simple op wrappers
# ---------------------------------------------------------------------------


def _unary(op_type):
    def f(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype_str)
        out.shape = tuple(x.shape)
        helper.append_op(op_type, {"X": x}, {"Out": out}, attrs)
        return out

    f.__name__ = op_type
    return f


relu = _unary("relu")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
gelu = _unary("gelu")
sqrt = _unary("sqrt")
square = _unary("square")
abs = _unary("abs")
exp = _unary("exp")
log = _unary("log")


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("leaky_relu", {"X": x}, {"Out": out}, {"alpha": alpha})
    return out


def softmax(input, axis=-1, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    out.shape = tuple(input.shape)
    helper.append_op("softmax", {"X": input}, {"Out": out}, {"axis": axis})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    helper.append_op("log_softmax", {"X": input}, {"Out": out}, {"axis": axis})
    return out


def softmax_with_cross_entropy(
    logits, label, soft_label=False, ignore_index=-100, axis=-1, return_softmax=False
):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype_str)
    loss = helper.create_variable_for_type_inference(logits.dtype_str)
    helper.append_op(
        "softmax_with_cross_entropy",
        {"Logits": logits, "Label": label},
        {"Softmax": softmax_out, "Loss": loss},
        {"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype_str)
    helper.append_op(
        "cross_entropy",
        {"X": input, "Label": label},
        {"Y": out},
        {"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype_str)
    helper.append_op("square_error_cost", {"X": input, "Y": label}, {"Out": out})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    out.shape = (1,)
    helper.append_op("mean", {"X": x}, {"Out": out})
    return out


def _reduce(op_type):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype_str)
        attrs = {"keep_dim": keep_dim, "reduce_all": dim is None}
        if dim is not None:
            attrs["dim"] = [dim] if isinstance(dim, int) else list(dim)
        helper.append_op(op_type, {"X": input}, {"Out": out}, attrs)
        return out

    return f


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")


def topk(input, k=1, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype_str)
    indices = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op("top_k", {"X": input}, {"Out": values, "Indices": indices}, {"k": k})
    return values, indices


def argmax(x, axis=-1, name=None):
    helper = LayerHelper("arg_max", name=name)
    out = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op("arg_max", {"X": x}, {"Out": out}, {"axis": axis})
    return out


def accuracy(input, label, k=1, name=None):
    helper = LayerHelper("accuracy", name=name)
    values, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    correct = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    total = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(
        "accuracy",
        {"Out": values, "Indices": indices, "Label": label},
        {"Accuracy": acc, "Correct": correct, "Total": total},
    )
    return acc


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype_str)
    helper.append_op("concat", {"X": input}, {"Out": out}, {"axis": axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype_str) for _ in range(n)]
    helper.append_op("split", {"X": input}, {"Out": outs}, attrs)
    return outs


def reshape(x, shape, name=None, inplace=False, act=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    out.shape = tuple(
        int(x.shape[i]) if s == 0 and i < len(x.shape) else int(s)
        for i, s in enumerate(shape)
    )
    xshape = helper.create_variable_for_type_inference(x.dtype_str, stop_gradient=True)
    helper.append_op(
        "reshape2", {"X": x}, {"Out": out, "XShape": xshape}, {"shape": list(shape)}
    )
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    if x.shape and len(x.shape) == len(perm):
        out.shape = tuple(x.shape[p] for p in perm)
    xshape = helper.create_variable_for_type_inference(x.dtype_str, stop_gradient=True)
    helper.append_op(
        "transpose2", {"X": x}, {"Out": out, "XShape": xshape}, {"axis": list(perm)}
    )
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    xshape = helper.create_variable_for_type_inference(x.dtype_str, stop_gradient=True)
    helper.append_op("flatten2", {"X": x}, {"Out": out, "XShape": xshape}, {"axis": axis})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    xshape = helper.create_variable_for_type_inference(input.dtype_str, stop_gradient=True)
    helper.append_op("squeeze2", {"X": input}, {"Out": out, "XShape": xshape}, {"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    xshape = helper.create_variable_for_type_inference(input.dtype_str, stop_gradient=True)
    helper.append_op("unsqueeze2", {"X": input}, {"Out": out, "XShape": xshape}, {"axes": list(axes)})
    return out


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    out = helper.create_variable_for_type_inference(x[0].dtype_str)
    helper.append_op("stack", {"X": x}, {"Y": out}, {"axis": axis})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtypes.to_str(dtype))
    helper.append_op(
        "cast",
        {"X": x},
        {"Out": out},
        {"in_dtype": x.dtype, "out_dtype": dtypes.to_enum(dtype)},
    )
    return out


def fill_constant(shape, dtype, value, name=None, out=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtypes.to_str(dtype), stop_gradient=True)
        out.shape = tuple(shape)
    helper.append_op(
        "fill_constant",
        {},
        {"Out": out},
        {"shape": list(shape), "dtype": dtypes.to_enum(dtype), "value": float(value)},
    )
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray) or not isinstance(input, Variable):
        input = _to_var(input, helper)
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype_str)
    helper.append_op("assign", {"X": input}, {"Out": output})
    return output


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("fill_any_like", {"X": x}, {"Out": out}, {"value": 0.0})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("fill_any_like", {"X": x}, {"Out": out}, {"value": 1.0})
    return out


def _binary(op_type):
    def f(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if not isinstance(y, Variable):
            y = _to_var(y, helper)
        out = helper.create_variable_for_type_inference(x.dtype_str)
        out.shape = tuple(x.shape)
        helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out}, {"axis": axis})
        return helper.append_activation(out, act)

    f.__name__ = op_type
    return f


elementwise_add = _binary("elementwise_add")
elementwise_sub = _binary("elementwise_sub")
elementwise_mul = _binary("elementwise_mul")
elementwise_div = _binary("elementwise_div")
elementwise_max = _binary("elementwise_max")
elementwise_min = _binary("elementwise_min")
elementwise_pow = _binary("elementwise_pow")


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op(
        "mul",
        {"X": x, "Y": y},
        {"Out": out},
        {"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    xs, ys = list(x.shape or ()), list(y.shape or ())
    if len(xs) >= 2 and len(ys) >= 2:
        m = xs[-1] if transpose_x else xs[-2]
        n = ys[-2] if transpose_y else ys[-1]
        xb, yb = xs[:-2], ys[:-2]
        # broadcast batch dims right-aligned (numpy semantics); dynamic
        # -1 dims survive unless the other operand pins a >1 extent
        # (then any valid runtime broadcast yields that extent)
        batch = []
        for i in range(max(len(xb), len(yb))):
            a = int(xb[-1 - i]) if i < len(xb) else 1
            c = int(yb[-1 - i]) if i < len(yb) else 1
            if a < 0 or c < 0:
                batch.append(max(a, c) if max(a, c) > 1 else -1)
            else:
                batch.append(max(a, c))
        batch.reverse()
        out.shape = tuple(batch) + (m, n)
    helper.append_op(
        "matmul",
        {"X": x, "Y": y},
        {"Out": out},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": float(alpha)},
    )
    return out


def fused_multihead_attention(q, k, v, num_heads, bias_qk=None, alpha=0.0,
                              name=None):
    """Fused scaled-dot-product attention over [B, S, hidden] q/k/v
    (reference operators/fused/multihead_matmul_op.cu).  On TPU this is
    one Pallas flash kernel; ``alpha=0`` means 1/sqrt(head_dim)."""
    helper = LayerHelper("fused_multihead_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype_str)
    out.shape = tuple(q.shape)
    inputs = {"Q": q, "K": k, "V": v}
    if bias_qk is not None:
        inputs["BiasQK"] = bias_qk
    helper.append_op(
        "fused_multihead_attention", inputs, {"Out": out},
        {"head_number": num_heads, "alpha": float(alpha)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    out.shape = tuple(x.shape)
    helper.append_op(
        "scale",
        {"X": x},
        {"Out": out},
        {"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out, act)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("clip", {"X": x}, {"Out": out}, {"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("clip_by_norm", {"X": x}, {"Out": out}, {"max_norm": float(max_norm)})
    return out


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("pow", {"X": x}, {"Out": out}, {"factor": float(factor)})
    return out


def sum(x):
    helper = LayerHelper("sum")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype_str)
    helper.append_op("sum", {"X": list(xs)}, {"Out": out})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot_v2", {"X": input}, {"Out": out}, {"depth": depth})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype_str)
    helper.append_op(
        "slice",
        {"Input": input},
        {"Out": out},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype_str)
    helper.append_op("gather", {"X": input, "Index": index}, {"Out": out})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    helper.append_op("gather_nd", {"X": input, "Index": index}, {"Out": out})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype_str)
    helper.append_op(
        "scatter",
        {"X": input, "Ids": index, "Updates": updates},
        {"Out": out},
        {"overwrite": overwrite},
    )
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("expand", {"X": x}, {"Out": out}, {"expand_times": list(expand_times)})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtypes.to_str(dtype), stop_gradient=True)
    helper.append_op(
        "uniform_random",
        {},
        {"Out": out},
        {"shape": list(shape), "dtype": dtypes.to_enum(dtype), "min": min, "max": max, "seed": seed},
    )
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtypes.to_str(dtype), stop_gradient=True)
    helper.append_op(
        "gaussian_random",
        {},
        {"Out": out},
        {"shape": list(shape), "dtype": dtypes.to_enum(dtype), "mean": mean, "std": std, "seed": seed},
    )
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op(
        "pad", {"X": x}, {"Out": out}, {"paddings": list(paddings), "pad_value": float(pad_value)}
    )
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("where", {"Condition": condition, "X": x, "Y": y}, {"Out": out})
    return out


def _compare(op_type):
    def f(x, y, cond=None):
        helper = LayerHelper(op_type)
        if not isinstance(y, Variable):
            y = _to_var(y, helper)
        out = cond or helper.create_variable_for_type_inference("bool", stop_gradient=True)
        helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out})
        return out

    return f


equal = _compare("equal")
not_equal = _compare("not_equal")
less_than = _compare("less_than")
less_equal = _compare("less_equal")
greater_than = _compare("greater_than")
greater_equal = _compare("greater_equal")


def logical_and(x, y, out=None, name=None):
    helper = LayerHelper("logical_and", name=name)
    out = out or helper.create_variable_for_type_inference("bool", stop_gradient=True)
    helper.append_op("logical_and", {"X": x, "Y": y}, {"Out": out})
    return out


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = out or helper.create_variable_for_type_inference("bool", stop_gradient=True)
    helper.append_op("logical_not", {"X": x}, {"Out": out})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype_str)
    helper.append_op("increment", {"X": x}, {"Out": out}, {"step": float(value)})
    return out


def cumsum(x, axis=None, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(x.dtype_str)
    attrs = {"flatten": axis is None}
    if axis is not None:
        attrs["axis"] = axis
    helper.append_op("cumsum", {"X": x}, {"Out": out}, attrs)
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op("shape", {"Input": input}, {"Out": out})
    return out


# ---------------------------------------------------------------------------
# control flow (reference python/paddle/fluid/layers/control_flow.py —
# While:1020, while_loop:1035, cond:2333; the ops run eagerly with a
# host-read predicate, see ops/control_flow.py)
# ---------------------------------------------------------------------------


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Functional while: loop_vars are updated in place by `body` until
    `cond` is false.  Carried state is exactly `loop_vars` (+ the
    condition), recorded on the op for the eager ``while`` lowering,
    which has no gradient rule."""
    if not loop_vars:
        raise ValueError("while_loop requires at least one loop var")
    prog = default_main_program()
    parent = prog.current_block()

    pre_cond = cond(*loop_vars)
    if tuple(getattr(pre_cond, "shape", ())) not in ((), (1,)):
        raise TypeError(
            f"while_loop condition must be a scalar, got shape "
            f"{pre_cond.shape}")

    sub = prog._create_block()
    out_vars = body(*loop_vars)
    if not isinstance(out_vars, (list, tuple)):
        out_vars = [out_vars]
    if len(out_vars) != len(loop_vars):
        raise ValueError(
            f"body returned {len(out_vars)} vars, expected {len(loop_vars)}")
    for lv, ov in zip(loop_vars, out_vars):
        if ov.name != lv.name:
            assign(ov, lv)
    new_cond = cond(*loop_vars)
    if new_cond.name != pre_cond.name:
        assign(new_cond, pre_cond)
    prog._rollback()

    carried = [pre_cond.name] + [lv.name for lv in loop_vars]
    parent.append_op(
        "while",
        {"X": carried, "Condition": [pre_cond.name]},
        {"Out": list(carried)},
        {"sub_block": sub.idx, "is_test": is_test},
    )
    return loop_vars


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two-branch conditional; both branches must produce matching
    structures (reference layers.cond:2333)."""
    helper = LayerHelper("cond", name=name)
    prog = default_main_program()
    parent = prog.current_block()

    def build(fn):
        sub = prog._create_block()
        out = fn() if fn is not None else None
        prog._rollback()
        if out is None:
            outs = []
        elif isinstance(out, (list, tuple)):
            outs = list(out)
        else:
            outs = [out]
        return sub, outs

    sub_t, t_outs = build(true_fn)
    sub_f, f_outs = build(false_fn)
    if len(t_outs) != len(f_outs):
        raise ValueError(
            f"cond branches return different numbers of outputs: "
            f"{len(t_outs)} vs {len(f_outs)}")
    results = []
    for tv in t_outs:
        out = helper.create_variable_for_type_inference(tv.dtype_str)
        out.shape = tuple(tv.shape)
        results.append(out)
    # record both branches' external reads as an input slot: the backward
    # (generic autograd over the re-run branch) differentiates w.r.t.
    # these — params captured inside a branch get gradients
    captured = []
    for sub, outs in ((sub_t, t_outs), (sub_f, f_outs)):
        local = set()
        for op in sub.ops:
            for n in op.input_arg_names():
                if n not in local and n != pred.name and n not in captured:
                    captured.append(n)
            local.update(op.output_arg_names())
        # a branch may return a pre-existing parent var directly (no ops);
        # it is still an input of the cond
        for v in outs:
            if v.name not in local and v.name != pred.name \
                    and v.name not in captured:
                captured.append(v.name)
    parent.append_op(
        "cond_pair",
        {"Cond": [pred.name], "Captured": captured},
        {"Out": [r.name for r in results]},
        {"sub_block_t": sub_t.idx, "sub_block_f": sub_f.idx,
         "t_outs": [v.name for v in t_outs],
         "f_outs": [v.name for v in f_outs]},
    )
    if not results:
        return None
    return results[0] if len(results) == 1 else results


class While:
    """v1.8-style while context manager:

        i = layers.fill_constant([1], "int64", 0)
        c = layers.less_than(i, n)
        w = layers.While(c)
        with w.block():
            ... ops updating state ...
            layers.increment(i)
            layers.assign(layers.less_than(i, n), c)

    Carried state is inferred from the sub-block: the condition, every
    var read before written inside the loop, and every loop-written var
    that was already produced in the parent block."""

    def __init__(self, cond, is_test=False, name=None):
        if tuple(getattr(cond, "shape", ())) not in ((), (1,)):
            raise TypeError(
                f"While condition must be a scalar, got shape {cond.shape}")
        self.cond_var = cond
        self.is_test = is_test

    def block(self):
        import contextlib

        prog = default_main_program()
        parent = prog.current_block()
        parent_written = set()
        for op in parent.ops:
            parent_written.update(op.output_arg_names())
        this = self

        @contextlib.contextmanager
        def guard():
            sub = prog._create_block()
            try:
                yield
            finally:
                prog._rollback()
                read_before_write = []
                written = set()
                for op in sub.ops:
                    for n in op.input_arg_names():
                        if n not in written and n not in read_before_write:
                            read_before_write.append(n)
                    written.update(op.output_arg_names())
                carried = [this.cond_var.name]
                for n in sorted(written):
                    if n == this.cond_var.name:
                        continue
                    if n in read_before_write or n in parent_written:
                        carried.append(n)
                parent.append_op(
                    "while",
                    {"X": carried, "Condition": [this.cond_var.name]},
                    {"Out": list(carried)},
                    {"sub_block": sub.idx, "is_test": this.is_test},
                )

        return guard()
