"""`paddle.nn.functional` equivalent (reference python/paddle/nn/functional/).

Counterpart of ``paddle_tpu/nn/functional.py``, ported whole.  Dual-mode:
every function runs eagerly on Tensors or appends IR ops for Variables
(see dispatch.op_call).  ``unfold``,
``interpolate`` and ``sequence_mask``, which have no IR op, run torch
directly (``dygraph.eager.apply_torch``), eager only.  ``interpolate``
matches the JAX package's ``jax.image.resize``: bilinear and bicubic
resize take half-pixel centres and antialias when they shrink (torch's
``antialias=True``, whose cubic is Keys' with a = -0.5, as jax's), and
the nearest resize rounds half-pixel centres (``nearest-exact``).  The
``*_interp`` ops (``ops/interp_ops.py``) keep the reference's own
coordinate rules instead.

``batch_norm`` in training writes the new running statistics into the
buffers it was given, detached from autograd's graph: they are state,
and a buffer that held the graph would keep every step's activations
alive.
"""
from __future__ import annotations

from ..dispatch import op_call
from ..framework import dtypes

# -- activations -------------------------------------------------------------


def _unary(op_type, **fixed):
    def fn(x, name=None, **kw):
        attrs = dict(fixed)
        attrs.update(kw)
        return op_call(op_type, {"X": x}, attrs, name=name)

    fn.__name__ = op_type
    return fn


relu = _unary("relu")
relu6 = _unary("relu6")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
softplus = _unary("softplus")
softsign = _unary("softsign")
silu = _unary("silu")
mish = _unary("mish")
tanhshrink = _unary("tanh_shrink")
log_sigmoid = _unary("logsigmoid")


def gelu(x, approximate=False, name=None):
    return op_call("gelu", {"X": x}, {"approximate": bool(approximate)}, name=name)


def leaky_relu(x, negative_slope=0.01, name=None):
    return op_call("leaky_relu", {"X": x}, {"alpha": float(negative_slope)}, name=name)


def elu(x, alpha=1.0, name=None):
    return op_call("elu", {"X": x}, {"alpha": float(alpha)}, name=name)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return op_call("selu", {"X": x}, {"scale": scale, "alpha": alpha}, name=name)


def celu(x, alpha=1.0, name=None):
    return op_call("celu", {"X": x}, {"alpha": float(alpha)}, name=name)


def hardswish(x, name=None):
    return op_call("hard_swish", {"X": x},
                   {"threshold": 6.0, "scale": 6.0, "offset": 3.0}, name=name)


def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    return op_call("hard_sigmoid", {"X": x}, {"slope": slope, "offset": offset}, name=name)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return op_call("brelu", {"X": x}, {"t_min": float(min), "t_max": float(max)}, name=name)


def hardshrink(x, threshold=0.5, name=None):
    return op_call("hard_shrink", {"X": x}, {"threshold": float(threshold)}, name=name)


def softshrink(x, threshold=0.5, name=None):
    return op_call("softshrink", {"X": x}, {"lambda": float(threshold)}, name=name)


def thresholded_relu(x, threshold=1.0, name=None):
    return op_call("thresholded_relu", {"X": x}, {"threshold": float(threshold)}, name=name)


def swish(x, name=None):
    return op_call("swish", {"X": x}, {"beta": 1.0}, name=name)


def prelu(x, weight, name=None):
    mode = "all" if int(_numel(weight)) == 1 else "channel"
    return op_call("prelu", {"X": x, "Alpha": weight}, {"mode": mode}, name=name)


def maxout(x, groups, axis=1, name=None):
    return op_call("maxout", {"X": x}, {"groups": int(groups), "axis": int(axis)},
                   name=name)


def softmax(x, axis=-1, dtype=None, name=None):
    out = op_call("softmax", {"X": x}, {"axis": int(axis)}, name=name)
    if dtype is not None:
        from ..tensor.math import cast

        out = cast(out, dtype)
    return out


def log_softmax(x, axis=-1, dtype=None, name=None):
    out = op_call("log_softmax", {"X": x}, {"axis": int(axis)}, name=name)
    if dtype is not None:
        from ..tensor.math import cast

        out = cast(out, dtype)
    return out


def _numel(x):
    import numpy as np

    return int(np.prod(x.shape)) if x.shape else 1


# -- linear / conv -----------------------------------------------------------


def linear(x, weight, bias=None, name=None):
    out = op_call("matmul_v2", {"X": x, "Y": weight},
                  {"trans_x": False, "trans_y": False}, name=name)
    if bias is not None:
        out = op_call("elementwise_add", {"X": out, "Y": bias}, {"axis": -1})
    return out


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    dilation = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    if isinstance(padding, str):
        pad_attr, pad_alg = [0, 0], padding.upper()
    else:
        pad_attr = [padding] * 2 if isinstance(padding, int) else list(padding)
        pad_alg = "EXPLICIT"
    out = op_call("conv2d", {"Input": x, "Filter": weight},
                  {"strides": stride, "paddings": pad_attr, "dilations": dilation,
                   "groups": int(groups), "padding_algorithm": pad_alg,
                   "data_format": data_format},
                  outs=("Output",), name=name)
    if bias is not None:
        out = op_call("elementwise_add", {"X": out, "Y": bias},
                      {"axis": 1 if data_format == "NCHW" else -1})
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    dilation = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    pad_attr = [padding] * 2 if isinstance(padding, int) else list(padding)
    out = op_call("conv2d_transpose", {"Input": x, "Filter": weight},
                  {"strides": stride, "paddings": pad_attr, "dilations": dilation,
                   "groups": int(groups), "data_format": data_format,
                   "output_padding": ([output_padding] * 2 if isinstance(output_padding, int)
                                      else list(output_padding)),
                   "output_size": list(output_size) if output_size else []},
                  outs=("Output",), name=name)
    if bias is not None:
        out = op_call("elementwise_add", {"X": out, "Y": bias},
                      {"axis": 1 if data_format == "NCHW" else -1})
    return out


# -- pooling -----------------------------------------------------------------


def _pool(x, kernel, pooling_type, stride, padding, ceil_mode, global_pooling,
          adaptive=False, exclusive=True, name=None):
    kernel = [kernel] * 2 if isinstance(kernel, int) else list(kernel)
    stride = kernel if stride is None else ([stride] * 2 if isinstance(stride, int) else list(stride))
    padding = [padding] * 2 if isinstance(padding, int) else list(padding)
    return op_call("pool2d", {"X": x},
                   {"ksize": kernel, "pooling_type": pooling_type, "strides": stride,
                    "paddings": padding, "ceil_mode": bool(ceil_mode),
                    "global_pooling": bool(global_pooling), "adaptive": bool(adaptive),
                    "exclusive": bool(exclusive)}, name=name)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    return _pool(x, kernel_size, "max", stride, padding, ceil_mode, False, name=name)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW", name=None):
    return _pool(x, kernel_size, "avg", stride, padding, ceil_mode, False,
                 exclusive=exclusive, name=name)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    size = [output_size] * 2 if isinstance(output_size, int) else list(output_size)
    return op_call("pool2d", {"X": x},
                   {"ksize": size, "pooling_type": "avg", "strides": [1, 1],
                    "paddings": [0, 0], "ceil_mode": False, "global_pooling": False,
                    "adaptive": True, "exclusive": True}, name=name)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    size = [output_size] * 2 if isinstance(output_size, int) else list(output_size)
    return op_call("pool2d", {"X": x},
                   {"ksize": size, "pooling_type": "max", "strides": [1, 1],
                    "paddings": [0, 0], "ceil_mode": False, "global_pooling": False,
                    "adaptive": True, "exclusive": True}, name=name)


# -- norm --------------------------------------------------------------------


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05, name=None):
    ns = [normalized_shape] if isinstance(normalized_shape, int) else list(normalized_shape)
    begin = len(x.shape) - len(ns)
    outs = op_call("layer_norm", {"X": x, "Scale": weight, "Bias": bias},
                   {"epsilon": float(epsilon), "begin_norm_axis": begin},
                   outs=("Y", "Mean", "Variance"), name=name)
    return outs[0]


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-05, data_format="NCHW", name=None):
    """Batch norm over ``x``.  Eagerly the running statistics' tensors
    take the op's new values; in a static program whose running
    statistics are graph variables (the hapi static adapter makes them
    persistable vars) the op writes them in place, as
    ``layers.batch_norm`` does.  The JAX package's function handles only
    the eager case (a graph ``MeanOut`` fails there)."""
    from ..framework.program import Variable

    attrs = {"momentum": float(momentum), "epsilon": float(epsilon),
             "is_test": not training, "data_layout": data_format,
             "use_global_stats": not training}
    if isinstance(running_mean, Variable):
        return _static_batch_norm(x, running_mean, running_var, weight, bias,
                                  attrs, name)
    outs = op_call("batch_norm",
                   {"X": x, "Scale": weight, "Bias": bias,
                    "Mean": running_mean, "Variance": running_var},
                   attrs,
                   outs=("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
                   name=name)
    y, mean_out, var_out = outs[0], outs[1], outs[2]
    if training and hasattr(running_mean, "_set_raw") \
            and hasattr(mean_out, "_value"):
        running_mean._set_raw(mean_out._value.detach())
        running_var._set_raw(var_out._value.detach())
    return y


def _static_batch_norm(x, mean, variance, weight, bias, attrs, name):
    from ..layer_helper import LayerHelper

    helper = LayerHelper("batch_norm", name=name)
    y = helper.create_variable_for_type_inference(x.dtype_str)
    y.shape = tuple(x.shape)
    saved = [helper.create_variable_for_type_inference(
        x.dtype_str, stop_gradient=True) for _ in range(2)]
    helper.append_op(
        "batch_norm",
        {"X": x, "Scale": weight, "Bias": bias, "Mean": mean,
         "Variance": variance},
        {"Y": y, "MeanOut": mean, "VarianceOut": variance,
         "SavedMean": saved[0], "SavedVariance": saved[1]},
        attrs)
    return y


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    outs = op_call("group_norm", {"X": x, "Scale": weight, "Bias": bias},
                   {"epsilon": float(epsilon), "groups": int(num_groups),
                    "data_layout": data_format},
                   outs=("Y", "Mean", "Variance"), name=name)
    return outs[0]


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    outs = op_call("instance_norm", {"X": x, "Scale": weight, "Bias": bias},
                   {"epsilon": float(eps)},
                   outs=("Y", "SavedMean", "SavedVariance"), name=name)
    return outs[0]


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    from ..tensor import linalg, math

    n = linalg.norm(x, p=float(p), axis=axis, keepdim=True)
    return math.divide(x, math.maximum(n, _full_like_scalar(n, epsilon)))


def _full_like_scalar(x, v):
    from ..tensor.creation import full_like

    return full_like(x, v)


# -- dropout / embedding -----------------------------------------------------


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    """Dropout; the op's ``Mask`` is an output too, since a static
    program's ``dropout_grad`` reads it (the JAX package asks for
    ``Out`` alone)."""
    impl = "upscale_in_train" if mode == "upscale_in_train" else "downgrade_in_infer"
    return op_call("dropout", {"X": x},
                   {"dropout_prob": float(p), "is_test": not training,
                    "dropout_implementation": impl},
                   outs=("Out", "Mask"), name=name)[0]


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    # sparse=True on one process is the JAX package's dense fallback:
    # out-of-vocab and padding ids give zero rows and no gradient
    return op_call("lookup_table_v2", {"Ids": x, "W": weight},
                   {"padding_idx": -1 if padding_idx is None else int(padding_idx),
                    "is_sparse": bool(sparse)},
                   name=name)


def one_hot(x, num_classes, name=None):
    return op_call("one_hot_v2", {"X": x}, {"depth": int(num_classes)},
                   dtype="float32", name=name)


# -- losses ------------------------------------------------------------------


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False):
    loss, sm = op_call("softmax_with_cross_entropy",
                       {"Logits": logits, "Label": label},
                       {"soft_label": bool(soft_label), "axis": int(axis),
                        "ignore_index": int(ignore_index)},
                       outs=("Loss", "Softmax"))
    return (loss, sm) if return_softmax else loss


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, name=None):
    from ..tensor import math as _m
    from ..tensor.manipulation import squeeze

    if weight is not None and not soft_label:
        lp = log_softmax(input, axis) if use_softmax else input
        return nll_loss(lp, label, weight, ignore_index, reduction)
    if use_softmax:
        loss = softmax_with_cross_entropy(input, label, soft_label, axis, ignore_index)
    else:
        loss = op_call("cross_entropy2", {"X": input, "Label": label},
                       {"ignore_index": int(ignore_index)}, outs=("Y",))
    if len(loss.shape) > 1 and loss.shape[-1] == 1:
        loss = squeeze(loss, -1)
    if reduction == "mean":
        return _m.mean(loss)
    if reduction == "sum":
        return _m.sum(loss)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    from ..tensor import math as _m

    loss = op_call("square_error_cost", {"X": input, "Y": label}, {})
    if reduction == "mean":
        return _m.mean(loss)
    if reduction == "sum":
        return _m.sum(loss)
    return loss


def l1_loss(input, label, reduction="mean", name=None):
    from ..tensor import math as _m

    loss = _m.abs(_m.subtract(input, label))
    if reduction == "mean":
        return _m.mean(loss)
    if reduction == "sum":
        return _m.sum(loss)
    return loss


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    loss = op_call("huber_loss", {"X": input, "Y": label}, {"delta": float(delta)},
                   outs=("Out",))
    from ..tensor import math as _m

    if reduction == "mean":
        return _m.mean(loss)
    if reduction == "sum":
        return _m.sum(loss)
    return loss


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    from ..tensor import math as _m

    if pos_weight is not None:
        # -[pw*y*log(sig(x)) + (1-y)*log(1-sig(x))], numerically stable form
        log_sig = _m.neg(softplus(_m.neg(logit)))
        log_one_minus = _m.neg(softplus(logit))
        loss = _m.neg(_m.add(_m.multiply(_m.multiply(label, pos_weight), log_sig),
                             _m.multiply(_m.subtract(
                                 _full_like_scalar(label, 1.0), label),
                                 log_one_minus)))
    else:
        loss = op_call("sigmoid_cross_entropy_with_logits",
                       {"X": logit, "Label": label}, {"ignore_index": -100})
    if weight is not None:
        loss = _m.multiply(loss, weight)
    if reduction == "mean":
        return _m.mean(loss)
    if reduction == "sum":
        return _m.sum(loss)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    """input is log-probabilities (reference nn/functional/loss.py nll_loss)."""
    from ..tensor import logic, math as _m
    from ..tensor.math import cast
    from .functional_helpers import gather_label_scores

    loss = _m.neg(gather_label_scores(input, label))
    w = None
    if weight is not None:
        w = gather_label_scores(
            _broadcast_rows(weight, input), label)
        loss = _m.multiply(loss, w)
    if ignore_index >= 0:
        keep = cast(logic.not_equal(
            label, _full_like_scalar(label, ignore_index)), input.dtype)
        if len(keep.shape) > len(loss.shape):
            from ..tensor.manipulation import squeeze

            keep = squeeze(keep, -1)
        loss = _m.multiply(loss, keep)
        if reduction == "mean":
            denom = _m.sum(_m.multiply(w, keep) if w is not None else keep)
            return _m.divide(_m.sum(loss), _m.maximum(
                denom, _full_like_scalar(denom, 1e-12)))
    if reduction == "mean":
        if w is not None:
            return _m.divide(_m.sum(loss), _m.sum(w))
        return _m.mean(loss)
    if reduction == "sum":
        return _m.sum(loss)
    return loss


def _broadcast_rows(weight, like):
    """[C] class-weight vector viewed as rows compatible with like [N, C]."""
    from ..tensor.manipulation import expand, unsqueeze

    w = unsqueeze(weight, 0)
    return expand(w, [like.shape[0], weight.shape[0]])


def kl_div(input, label, reduction="mean", name=None):
    from ..tensor import math as _m

    # input is log-prob, label is prob: label * (log(label) - input)
    eps = 1e-12
    term = _m.multiply(label, _m.subtract(_m.log(_m.maximum(
        label, _full_like_scalar(label, eps))), input))
    if reduction == "mean":
        return _m.mean(term)
    if reduction == "sum":
        return _m.sum(term)
    return term


# -- shape/pad/misc ----------------------------------------------------------


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if mode != "constant":
        # reflect/replicate/circular ride the pad2d/pad3d op (reference
        # operators/pad2d_op); `pad` here is the spatial-only pair list
        op_type = "pad3d" if len(x.shape) == 5 else "pad2d"
        return op_call(op_type, {"X": x},
                       {"paddings": [int(p) for p in pad], "mode": mode,
                        "value": float(value), "data_format": data_format},
                       name=name)
    if len(pad) == len(x.shape) * 2:
        paddings = list(pad)
    else:
        # paddle 2.x: pad only the trailing dims, [left, right, ...] per dim pair
        n_pre = len(x.shape) - len(pad) // 2
        paddings = [0, 0] * n_pre
        # reference order: last-dim pairs come first in `pad`
        dims = len(pad) // 2
        per_dim = [pad[2 * i:2 * i + 2] for i in range(dims)]
        for pr in reversed(per_dim):
            paddings.extend(pr)
    return op_call("pad", {"X": x}, {"paddings": paddings, "pad_value": float(value)},
                   name=name)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    from ..dygraph.eager import apply_torch
    import torch.nn.functional as TF

    ks = [kernel_sizes] * 2 if isinstance(kernel_sizes, int) else list(kernel_sizes)
    st = [strides] * 2 if isinstance(strides, int) else list(strides)
    pd = [paddings] * 2 if isinstance(paddings, int) else list(paddings)
    dl = [dilations] * 2 if isinstance(dilations, int) else list(dilations)

    return apply_torch(lambda v: TF.unfold(v, ks, dilation=dl, padding=pd,
                                           stride=st), x)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW", name=None):
    from ..dygraph.eager import apply_torch
    import torch.nn.functional as TF

    h, w = int(x.shape[2]), int(x.shape[3])
    if size is not None:
        oh, ow = int(size[0]), int(size[1])
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else [scale_factor] * 2
        oh, ow = int(h * sf[0]), int(w * sf[1])
    method = {"nearest": "nearest-exact", "bilinear": "bilinear",
              "bicubic": "bicubic"}[mode]
    extra = {} if method == "nearest-exact" else {"align_corners": False,
                                                  "antialias": True}

    return apply_torch(lambda v: TF.interpolate(v, size=(oh, ow), mode=method,
                                                **extra), x)


upsample = interpolate


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    from ..tensor import math as _m

    k = label.shape[-1]
    smoothed = _m.scale(label, 1.0 - epsilon, bias=0.0)
    return _m.add(smoothed, _full_like_scalar(label, epsilon / k))


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    from ..dygraph.eager import apply_torch
    import torch

    m = int(maxlen) if maxlen is not None else None
    if m is None:
        raise ValueError("maxlen must be given (static shapes, as in the "
                         "JAX package)")

    def fn(v):
        return (torch.arange(m, device=v.device)[None, :] < v[:, None]).to(
            dtypes.to_torch(dtype))

    return apply_torch(fn, lengths)
