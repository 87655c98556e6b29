"""NN ops: ``conv2d`` / ``depthwise_conv2d`` (+ grad), ``pool2d``,
``batch_norm`` / ``sync_batch_norm`` (+ grad), ``softmax``,
``log_softmax``, ``softmax_with_cross_entropy`` (+ grad), the losses
``cross_entropy`` / ``cross_entropy2``,
``sigmoid_cross_entropy_with_logits``, ``square_error_cost`` and
``huber_loss``, and ``layer_norm``.

Counterpart of ``paddle_tpu/ops/nn_ops.py``, with ``conv2d_transpose``,
``instance_norm`` and ``group_norm`` (their gradients are the generic
one, ``grad_generic.py``).
Reference parity: operators/conv_op.cc, pool_op.cc, batch_norm_op.cc,
softmax_op.cc (``softmax_grad`` takes the generic gradient),
softmax_with_cross_entropy_op.h (``ignore_index`` positions carry zero
loss and zero gradient, whatever its sign) and layer_norm_op.cc
(``begin_norm_axis``; ``Mean``/``Variance`` outputs flattened to the
leading dims).

Convolution and pooling run on cuDNN / ATen (``F.conv2d``,
``F.max_pool2d``; the JAX package's are XLA ops, not Pallas kernels), in
NCHW with OIHW filters; NHWC inputs are transposed in and out, as the JAX
lowering does.  Both pad symmetrically only, so an asymmetric pair
(``SAME`` on even sizes, 4-element ``paddings``) is padded with ``F.pad``
first.  ``pool2d`` ignores ``ceil_mode``, as the JAX lowering does.
``conv2d_transpose`` runs ``F.conv_transpose2d`` with the JAX lowering's
arithmetic: its pads are those of the forward convolution (``paddings``
or ``padding_algorithm``, SAME sized from the input), taken off a full
transposed convolution (an asymmetric pair is cropped), and
``output_padding`` appends zeros; like the JAX lowering it reads no
``output_size``.  It transposes NHWC in and out, which the JAX lowering
does not (it reads no ``data_format``: the tests hold NHWC to its NCHW
result, transposed).

The JAX package differentiates conv and batch norm with ``jax.vjp`` of
these lowerings inside one XLA computation.  Run eagerly, the generic
gradient would replay each forward (``grad_generic.py``), so
``conv2d_grad`` is one ``aten.convolution_backward`` call (cuDNN's data
and filter gradients) and ``batch_norm_grad`` the reference's closed
form; both compute the function ``jax.vjp`` gives.  ``pool2d_grad``
takes the generic gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower
from .common import adaptive_windows

# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


def _conv_paddings(paddings, padding_algorithm, ksize, strides, dilations,
                   in_hw):
    """Resolve reference padding semantics -> ((lo, hi), ...) pairs."""
    nd = len(ksize)
    if padding_algorithm == "VALID":
        return [(0, 0)] * nd
    if padding_algorithm == "SAME":
        pads = []
        for i in range(nd):
            eff = (ksize[i] - 1) * dilations[i] + 1
            out = -(-in_hw[i] // strides[i])
            total = max(0, (out - 1) * strides[i] + eff - in_hw[i])
            pads.append((total // 2, total - total // 2))
        return pads
    paddings = [int(p) for p in paddings]
    if len(paddings) == nd:
        return [(p, p) for p in paddings]
    if len(paddings) == 2 * nd:
        return [(paddings[2 * i], paddings[2 * i + 1]) for i in range(nd)]
    raise ValueError(f"bad paddings {paddings}")


def _torch_pad(pads):
    """((h_lo, h_hi), (w_lo, w_hi)) as ``F.pad``'s last-dim-first list."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    return [w_lo, w_hi, h_lo, h_hi]


def _conv_geometry(op, x, w):
    """(x in NCHW, padded first where its padding is asymmetric; the
    ``F.conv2d`` arguments; the (lo, hi) pads; whether x was NHWC)."""
    strides = [int(s) for s in op.attr("strides", [1, 1])]
    dilations = [int(d) for d in op.attr("dilations", [1, 1])]
    groups = int(op.attr("groups", 1) or 1)
    nhwc = (op.attr("data_format", "NCHW") or "NCHW") in ("NHWC", "NDHWC")
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if op.type.startswith("depthwise_conv2d"):
        groups = x.shape[1]
    pads = _conv_paddings(op.attr("paddings", [0, 0]),
                          op.attr("padding_algorithm", "EXPLICIT"),
                          w.shape[2:], strides, dilations, x.shape[2:])
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x, padding = F.pad(x, _torch_pad(pads)), [0, 0]
    return x, dict(stride=strides, padding=padding, dilation=dilations,
                   groups=groups), pads, nhwc


@register_lower("conv2d", "depthwise_conv2d")
def _conv2d(ctx, op):
    w = ctx.in1(op, "Filter")  # OIHW
    x, conv, _pads, nhwc = _conv_geometry(op, ctx.in1(op, "Input"), w)
    out = F.conv2d(x, w, **conv)
    ctx.set_out(op, "Output", out.permute(0, 2, 3, 1) if nhwc else out)


@register_lower("conv2d_grad", "depthwise_conv2d_grad")
def _conv2d_grad(ctx, op):
    """Input@GRAD and Filter@GRAD from one ``convolution_backward`` call,
    in the forward's dtypes; an asymmetric pad is applied to x first and
    cropped off its gradient."""
    x0 = ctx.in1(op, "Input")
    w = ctx.in1(op, "Filter")
    dy = ctx.in1(op, "Output@GRAD")
    x, conv, pads, nhwc = _conv_geometry(op, x0, w)
    if nhwc:
        dy = dy.permute(0, 3, 1, 2)
    want_x = bool(ctx.out_name(op, "Input@GRAD"))
    want_w = bool(ctx.out_name(op, "Filter@GRAD"))
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.to(x.dtype).contiguous(), x.contiguous(), w, None, conv["stride"],
        conv["padding"], conv["dilation"], False, [0, 0], conv["groups"],
        [want_x, want_w, False])
    if want_x:
        if conv["padding"] == [0, 0] and any(map(any, pads)):
            (h_lo, h_hi), (w_lo, w_hi) = pads
            dx = dx[:, :, h_lo:dx.shape[2] - h_hi, w_lo:dx.shape[3] - w_hi]
        if nhwc:
            dx = dx.permute(0, 2, 3, 1)
        ctx.set_out(op, "Input@GRAD", dx.to(x0.dtype))
    if want_w:
        ctx.set_out(op, "Filter@GRAD", dw.to(w.dtype))


@register_lower("conv2d_transpose")
def _conv2d_transpose(ctx, op):
    x = ctx.in1(op, "Input")
    w = ctx.in1(op, "Filter")  # [in, out / groups, kh, kw]
    strides = [int(s) for s in op.attr("strides", [1, 1])]
    dilations = [int(d) for d in op.attr("dilations", [1, 1])]
    groups = int(op.attr("groups", 1) or 1)
    nhwc = (op.attr("data_format", "NCHW") or "NCHW") in ("NHWC", "NDHWC")
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    # the forward convolution's pads; the transposed convolution pads its
    # dilated input by (k - 1) * d - pad, i.e. a full transposed
    # convolution (torch's padding 0) with `pad` cropped off each side
    pads = _conv_paddings(op.attr("paddings", [0, 0]),
                          op.attr("padding_algorithm", "EXPLICIT"),
                          w.shape[2:], strides, dilations, x.shape[2:])
    sym = all(lo == hi for lo, hi in pads)
    out = F.conv_transpose2d(
        x, w, stride=strides, padding=[lo for lo, _ in pads] if sym else 0,
        groups=groups, dilation=dilations)
    if not sym:
        (h_lo, h_hi), (w_lo, w_hi) = pads
        out = out[:, :, h_lo:out.shape[2] - h_hi, w_lo:out.shape[3] - w_hi]
    output_padding = [int(p) for p in op.attr("output_padding", []) or []]
    if any(output_padding):
        out = F.pad(out, [0, output_padding[1], 0, output_padding[0]])
    ctx.set_out(op, "Output", out.permute(0, 2, 3, 1) if nhwc else out)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def _lowest(dtype):
    return float("-inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).min


def _adaptive_pool_1d(x, axis, out_size, ptype):
    """Adaptive pooling along one axis with arbitrary output size: gather
    each cell's window (fixed max width) and reduce under a validity
    mask.  Dtype-preserving like the divisible-size branch.  The windows
    (``adaptive_windows``'s) are built on x's device, with no host copy
    that a captured step could not hold."""
    ih = int(x.shape[axis])
    maxw = adaptive_windows(ih, out_size)[2]
    cell = torch.arange(out_size, device=x.device)
    starts = torch.div(cell * ih, out_size, rounding_mode="floor")
    ends = -torch.div(-(cell + 1) * ih, out_size, rounding_mode="floor")
    idx = starts[:, None] + torch.arange(maxw, device=x.device)[None, :]
    valid = idx < ends[:, None]
    g = torch.index_select(x, axis, idx.clamp(max=ih - 1).ravel())
    new_shape = x.shape[:axis] + (out_size, maxw) + x.shape[axis + 1:]
    g = g.reshape(new_shape)
    mshape = [1] * len(new_shape)
    mshape[axis], mshape[axis + 1] = out_size, maxw
    m = valid.reshape(mshape)
    if ptype == "max":
        return torch.where(m, g, torch.full((), _lowest(g.dtype),
                                            dtype=g.dtype, device=g.device)
                           ).amax(dim=axis + 1)
    counts = valid.sum(1).to(g.dtype)
    counts = counts.reshape([out_size if i == axis else 1
                             for i in range(len(new_shape) - 1)])
    return torch.where(m, g, torch.zeros((), dtype=g.dtype, device=g.device)
                       ).sum(dim=axis + 1) / counts


def _window_pool(x, ptype, ksize, strides, pads, exclusive):
    """A windowed max or average over NCHW ``x`` with ((lo, hi), (lo, hi))
    padding; the average divides by the count of real elements
    (``exclusive``) or by the window's size."""
    small = all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, ksize))
    if ptype == "max":
        if small and x.is_floating_point():
            return F.max_pool2d(x, ksize, strides, [lo for lo, _ in pads])
        xp = F.pad(x, _torch_pad(pads), value=_lowest(x.dtype))
        if x.is_floating_point():
            return F.max_pool2d(xp, ksize, strides)
        # integers: ATen's max pooling takes floating types only
        return xp.unfold(2, ksize[0], strides[0]).unfold(
            3, ksize[1], strides[1]).amax(dim=(-2, -1))
    if small:
        return F.avg_pool2d(x, ksize, strides, [lo for lo, _ in pads],
                            count_include_pad=not exclusive)
    s = F.avg_pool2d(F.pad(x, _torch_pad(pads)), ksize, strides,
                     divisor_override=1)
    if not exclusive:
        return s / float(ksize[0] * ksize[1])
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    cnt = F.avg_pool2d(F.pad(ones, _torch_pad(pads)), ksize, strides,
                       divisor_override=1)
    return s / cnt


@register_lower("pool2d")
def _pool2d(ctx, op):
    x = ctx.in1(op, "X")
    ptype = op.attr("pooling_type", "max")
    ksize = [int(k) for k in op.attr("ksize", [1, 1])]
    strides = [int(s) for s in op.attr("strides", [1, 1])]
    adaptive = bool(op.attr("adaptive", False))
    nhwc = (op.attr("data_format", "NCHW") or "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)

    if bool(op.attr("global_pooling", False)) or (adaptive
                                                  and ksize == [1, 1]):
        out = x.amax(dim=(2, 3), keepdim=True) if ptype == "max" \
            else x.mean(dim=(2, 3), keepdim=True)
    elif adaptive:
        oh, ow = ksize
        ih, iw = x.shape[2:]
        if ih % oh == 0 and iw % ow == 0:
            x6 = x.reshape(x.shape[0], x.shape[1], oh, ih // oh, ow,
                           iw // ow)
            out = x6.amax(dim=(3, 5)) if ptype == "max" \
                else x6.mean(dim=(3, 5))
        else:
            # non-divisible windows (reference AdaptivePool: cell i pools
            # [floor(i*I/O), ceil((i+1)*I/O))), separable per axis
            out = _adaptive_pool_1d(x, 2, oh, ptype)
            out = _adaptive_pool_1d(out, 3, ow, ptype)
    else:
        pads = _conv_paddings(op.attr("paddings", [0, 0]),
                              op.attr("padding_algorithm", "EXPLICIT"),
                              ksize, strides, [1, 1], x.shape[2:])
        out = _window_pool(x, ptype, ksize, strides, pads,
                           bool(op.attr("exclusive", True)))
    if nhwc:
        out = out.permute(0, 2, 3, 1)
    ctx.set_out(op, "Out", out)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def _bn_axes(op, x):
    """(channel axis, reduced axes, broadcast shape of a [C] vector)."""
    layout = op.attr("data_layout", "NCHW") or "NCHW"
    caxis = 1 if layout == "NCHW" else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != caxis)
    bshape = [1] * x.dim()
    bshape[caxis] = x.shape[caxis]
    return caxis, red, bshape


def _bn_global(op):
    return bool(op.attr("use_global_stats", False)) \
        or bool(op.attr("is_test", False))


def _bn_acc(x):
    """The statistics' dtype: float32, float64 for float64 input (the
    reference's accumulation type)."""
    return torch.promote_types(x.dtype, torch.float32)


def _bn_moments(x, red, eps):
    """One-pass moments (``E[x^2] - E[x]^2`` clamped at 0) in
    ``_bn_acc(x)``, and the inverse std."""
    xf = x.to(_bn_acc(x))
    m = xf.mean(dim=red)
    v = (xf.square().mean(dim=red) - m.square()).clamp_min(0.0)
    return m, v, torch.rsqrt(v + eps)


def _bn_normalize(x, scale, bias, m, inv, bshape):
    acc = m.dtype
    return ((x.to(acc) - m.reshape(bshape)) * inv.reshape(bshape)
            * scale.to(acc).reshape(bshape)
            + bias.to(acc).reshape(bshape)).to(x.dtype)


def _bn_train_grads(x, scale, dy, m, inv, red, bshape):
    """The reference's closed form under batch statistics, in
    ``_bn_acc(x)``: dBias = sum(dy), dScale = sum(dy * x_hat), dX = scale
    * inv * (dy - (dBias + x_hat * dScale) / N); dX in x's dtype."""
    acc = _bn_acc(x)
    dy = dy.to(acc)
    m, inv = m.to(acc).reshape(bshape), inv.to(acc).reshape(bshape)
    x_hat = (x.to(acc) - m) * inv
    d_bias = dy.sum(dim=red)
    d_scale = (dy * x_hat).sum(dim=red)
    n = x.numel() // d_bias.numel()
    dx = scale.to(acc).reshape(bshape) * inv * (
        dy - (d_bias.reshape(bshape) + x_hat * d_scale.reshape(bshape)) / n)
    return dx.to(x.dtype), d_scale, d_bias


def _bn_batch_stats(x, scale, bias, eps, red, bshape):
    """(y, mean, var, inv std) under batch statistics, every step plain
    ATen code (autograd differentiates the one-pass moments)."""
    m, v, inv = _bn_moments(x, red, eps)
    return _bn_normalize(x, scale, bias, m, inv, bshape), m, v, inv


class _BatchNormTrain(torch.autograd.Function):
    """``_bn_batch_stats`` with the closed form (``_bn_train_grads``) as
    its backward: the eager (dygraph) rule's batch statistics, bound by
    ``batch_norm_eager``.  Autograd through the one-pass moments keeps
    every float32 intermediate of the forward alive until the backward
    and differentiates them pass by pass; ``tools/dygraph_bn_ab.py`` times
    both on a dygraph ResNet-50 step.  The statistics it returns are not
    differentiable."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, red, bshape):
        m, v, inv = _bn_moments(x, red, eps)
        ctx.save_for_backward(x, scale, m, inv)
        ctx.red, ctx.bshape, ctx.bias_dtype = red, bshape, bias.dtype
        ctx.mark_non_differentiable(m, v, inv)
        return _bn_normalize(x, scale, bias, m, inv, bshape), m, v, inv

    @staticmethod
    def backward(ctx, dy, _dm, _dv, _dinv):
        x, scale, m, inv = ctx.saved_tensors
        dx, d_scale, d_bias = _bn_train_grads(x, scale, dy, m, inv,
                                              ctx.red, ctx.bshape)
        return (dx, d_scale.to(scale.dtype), d_bias.to(ctx.bias_dtype),
                None, None, None)


def _bn_apply(ctx, op, batch_stats):
    """The batch-norm op's outputs, ``batch_stats`` giving (y, mean, var,
    inv std) under batch statistics."""
    x = ctx.in1(op, "X")
    scale = ctx.in1(op, "Scale")
    bias = ctx.in1(op, "Bias")
    mean = ctx.in1(op, "Mean")
    var = ctx.in1(op, "Variance")
    eps = float(op.attr("epsilon", 1e-5))
    momentum = float(op.attr("momentum", 0.9))
    _caxis, red, bshape = _bn_axes(op, x)
    if _bn_global(op):
        acc = _bn_acc(x)
        m, inv = mean.to(acc), torch.rsqrt(var.to(acc) + eps)
        y = _bn_normalize(x, scale, bias, m, inv, bshape)
        ctx.set_out(op, "MeanOut", mean)
        ctx.set_out(op, "VarianceOut", var)
    else:
        y, m, v, inv = batch_stats(x, scale, bias, eps, red, bshape)
        ctx.set_out(op, "MeanOut",
                    momentum * mean + (1 - momentum) * m.to(mean.dtype))
        ctx.set_out(op, "VarianceOut",
                    momentum * var + (1 - momentum) * v.to(var.dtype))
    ctx.set_out(op, "Y", y)
    ctx.set_out(op, "SavedMean", m)
    ctx.set_out(op, "SavedVariance", inv)


@register_lower("batch_norm", "sync_batch_norm")
def _batch_norm(ctx, op):
    """The JAX lowering's arithmetic: statistics in float32 (float64 for
    float64 input, which the JAX package does not run) from one-pass
    moments (``E[x^2] - E[x]^2`` clamped at 0), Y in ``x.dtype`` (bf16
    under AMP), the running statistics moved with the reference's
    momentum convention (``momentum * running + (1 - momentum) * batch``,
    the biased batch variance), ``SavedVariance`` the inverse std.  One
    process: ``sync_batch_norm`` is ``batch_norm``."""
    _bn_apply(ctx, op, _bn_batch_stats)


def batch_norm_eager(ctx, op):
    """Dygraph's rule for ``batch_norm`` / ``sync_batch_norm``
    (``dygraph/eager.py``): the lowering's arithmetic, with batch
    statistics through ``_BatchNormTrain``, whose backward is the closed
    form the static ``batch_norm_grad`` runs."""
    _bn_apply(ctx, op, _BatchNormTrain.apply)


@register_lower("batch_norm_grad", "sync_batch_norm_grad")
def _batch_norm_grad(ctx, op):
    """The reference's closed form (batch_norm_op.cc, BatchNormGradKernel)
    from X, Scale, SavedMean, SavedVariance (the inverse std) and
    Y@GRAD, in ``_bn_acc(x)`` (``_bn_train_grads``), or scale * inv * dy
    under global statistics; dX in x's dtype.  The running statistics enter Y
    only under global statistics, and only there have a gradient (zeros
    in training, where one is asked for)."""
    x = ctx.in1(op, "X")
    scale = ctx.in1(op, "Scale")
    dy = ctx.in1(op, "Y@GRAD")
    _caxis, red, bshape = _bn_axes(op, x)
    m = ctx.in1(op, "SavedMean")
    acc = _bn_acc(x)
    inv = ctx.in1(op, "SavedVariance").to(acc)
    mean, var = ctx.in1(op, "Mean"), ctx.in1(op, "Variance")
    if _bn_global(op):
        dyf = dy.to(acc)
        x_hat = (x.to(acc) - m.to(acc).reshape(bshape)) * inv.reshape(bshape)
        d_bias = dyf.sum(dim=red)
        d_scale = (dyf * x_hat).sum(dim=red)
        dx = (scale.to(acc).reshape(bshape) * inv.reshape(bshape) * dyf
              ).to(x.dtype)
        s_inv = scale.to(acc) * inv
        d_mean = -s_inv * d_bias
        d_var = -0.5 * s_inv * inv * d_scale
    else:
        dx, d_scale, d_bias = _bn_train_grads(x, scale, dy, m, inv, red,
                                              bshape)
        d_mean, d_var = torch.zeros_like(mean), torch.zeros_like(var)
    ctx.set_out(op, "X@GRAD", dx)
    ctx.set_out(op, "Scale@GRAD", d_scale.to(scale.dtype))
    ctx.set_out(op, "Bias@GRAD", d_bias.to(ctx.in1(op, "Bias").dtype))
    ctx.set_out(op, "Mean@GRAD", d_mean.to(mean.dtype))
    ctx.set_out(op, "Variance@GRAD", d_var.to(var.dtype))


@register_lower("softmax")
def _softmax(ctx, op):
    """bf16-transparent: exp/sum run in float32 (bf16's 8 significant
    bits lose small probabilities), Out follows x.dtype so attention prob
    tensors stay bf16 under AMP."""
    x = ctx.in1(op, "X")
    out = torch.softmax(x.float(), dim=int(op.attr("axis", -1)))
    ctx.set_out(op, "Out", out.to(x.dtype))


def _hard_labels(label, ndim, axis):
    lbl = label
    if lbl.dim() == ndim and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    return lbl.long()


@register_lower("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, op):
    logits = ctx.in1(op, "Logits")
    label = ctx.in1(op, "Label")
    axis = int(op.attr("axis", -1)) % logits.dim()
    ignore_index = int(op.attr("ignore_index", -100))
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if bool(op.attr("soft_label", False)):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = _hard_labels(label, logits.dim(), axis)
        # clip negative ignore labels (e.g. -1/-100) before the gather;
        # an out-of-range index would otherwise pick a real vocab row
        safe = lbl.clamp(0, logits.shape[axis] - 1)
        picked = torch.gather(logp, axis, safe.unsqueeze(axis))
        mask = lbl.unsqueeze(axis) != ignore_index
        loss = torch.where(mask, -picked, torch.zeros_like(picked))
    ctx.set_out(op, "Softmax", softmax)
    ctx.set_out(op, "Loss", loss)


@register_lower("softmax_with_cross_entropy_grad")
def _softmax_with_cross_entropy_grad(ctx, op):
    softmax = ctx.in1(op, "Softmax")
    label = ctx.in1(op, "Label")
    dloss = ctx.in1(op, "Loss@GRAD")
    axis = int(op.attr("axis", -1)) % softmax.dim()
    ignore_index = int(op.attr("ignore_index", -100))
    if bool(op.attr("soft_label", False)):
        dlogits = (softmax - label) * dloss
    else:
        lbl = _hard_labels(label, softmax.dim(), axis)
        safe = lbl.clamp(0, softmax.shape[axis] - 1)
        onehot = F.one_hot(safe, softmax.shape[axis]).to(softmax.dtype)
        onehot = onehot.movedim(-1, axis)
        dlogits = (softmax - onehot) * dloss
        # ignored positions contribute zero loss -> zero gradient
        mask = (lbl != ignore_index).unsqueeze(axis)
        dlogits = torch.where(mask, dlogits, torch.zeros_like(dlogits))
    ctx.set_out(op, "Logits@GRAD", dlogits)


@register_lower("layer_norm")
def _layer_norm(ctx, op):
    x = ctx.in1(op, "X")
    scale = ctx.get_opt((op.inputs.get("Scale") or [None])[0])
    bias = ctx.get_opt((op.inputs.get("Bias") or [None])[0])
    eps = float(op.attr("epsilon", 1e-5))
    begin = int(op.attr("begin_norm_axis", 1))
    red = tuple(range(begin, x.dim()))
    xf = x.float()
    # one-pass float32 moments, exactly the JAX package's formula (its
    # E[x^2] - E[x]^2 cancellation trade-off included)
    m = xf.mean(dim=red, keepdim=True)
    v = (xf.square().mean(dim=red, keepdim=True) - m.square()).clamp_min(0.0)
    y = (xf - m) * torch.rsqrt(v + eps)
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape).float()
    if bias is not None:
        y = y + bias.reshape(norm_shape).float()
    ctx.set_out(op, "Y", y.to(x.dtype))
    ctx.set_out(op, "Mean", m.reshape(-1))
    ctx.set_out(op, "Variance", v.reshape(-1))


@register_lower("instance_norm")
def _instance_norm(ctx, op):
    x = ctx.in1(op, "X")
    scale = ctx.in1(op, "Scale")
    bias = ctx.in1(op, "Bias")
    eps = float(op.attr("epsilon", 1e-5))
    red = tuple(range(2, x.dim()))
    m = x.mean(dim=red, keepdim=True)
    v = x.var(dim=red, keepdim=True, unbiased=False)
    inv = torch.rsqrt(v + eps)
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    y = (x - m) * inv * scale.reshape(shape) + bias.reshape(shape)
    ctx.set_out(op, "Y", y)
    ctx.set_out(op, "SavedMean", m.squeeze())
    # the JAX package's SavedVariance is the inverse deviation
    ctx.set_out(op, "SavedVariance", inv.squeeze())


@register_lower("group_norm")
def _group_norm(ctx, op):
    x = ctx.in1(op, "X")  # NCHW
    scale = ctx.get_opt((op.inputs.get("Scale") or [None])[0])
    bias = ctx.get_opt((op.inputs.get("Bias") or [None])[0])
    eps = float(op.attr("epsilon", 1e-5))
    groups = int(op.attr("groups", 1))
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    red = tuple(range(2, xg.dim()))
    m = xg.mean(dim=red, keepdim=True)
    v = xg.var(dim=red, keepdim=True, unbiased=False)
    y = ((xg - m) * torch.rsqrt(v + eps)).reshape(x.shape)
    shape = [1, c] + [1] * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    ctx.set_out(op, "Y", y)
    ctx.set_out(op, "Mean", m.reshape(n, groups))
    ctx.set_out(op, "Variance", v.reshape(n, groups))


@register_lower("log_softmax")
def _log_softmax(ctx, op):
    ctx.set_out(op, "Out", torch.log_softmax(ctx.in1(op, "X"),
                                             dim=int(op.attr("axis", -1))))


@register_lower("cross_entropy", "cross_entropy2")
def _cross_entropy(ctx, op):
    """X holds probabilities: the loss is -log of the label's, clipped
    at 1e-12."""
    x = ctx.in1(op, "X")
    label = ctx.in1(op, "Label")
    logp = torch.log(torch.clamp(x, 1e-12, 1.0))
    if bool(op.attr("soft_label", False)):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        lbl = label.squeeze(-1) if label.dim() == x.dim() \
            and label.shape[-1] == 1 else label
        loss = -torch.gather(logp, -1, lbl.long().unsqueeze(-1))
    ctx.set_out(op, "Y", loss)
    if op.outputs.get("XShape"):
        ctx.set_out(op, "XShape", x.new_zeros((0,) + tuple(x.shape)))


@register_lower("sigmoid_cross_entropy_with_logits")
def _bce_logits(ctx, op):
    """max(x, 0) - x z + log(1 + e^-|x|), zero where the label is
    ``ignore_index`` (when one is set), over the kept count when
    ``normalize``."""
    x = ctx.in1(op, "X")
    label = ctx.in1(op, "Label")
    loss = torch.clamp_min(x, 0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    ignore_index = int(op.attr("ignore_index", -100))
    if ignore_index != -100:
        loss = torch.where(label == ignore_index, torch.zeros_like(loss),
                           loss)
    if bool(op.attr("normalize", False)):
        loss = loss / torch.clamp_min(
            (label != ignore_index).to(x.dtype).sum(), 1.0)
    ctx.set_out(op, "Out", loss)


@register_lower("square_error_cost")
def _square_error_cost(ctx, op):
    ctx.set_out(op, "Out", torch.square(ctx.in1(op, "X") - ctx.in1(op, "Y")))


@register_lower("cos_sim")
def _cos_sim(ctx, op):
    """Row-wise cosine similarity over the last axis, the norms beside."""
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / torch.clamp_min(
        xn * yn, 1e-12)
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "XNorm", xn)
    ctx.set_out(op, "YNorm", yn)


@register_lower("huber_loss")
def _huber_loss(ctx, op):
    r = ctx.in1(op, "Y") - ctx.in1(op, "X")
    d = float(op.attr("delta", 1.0))
    a = torch.abs(r)
    ctx.set_out(op, "Out", torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d)))
    ctx.set_out(op, "Residual", r)
