"""Metric ops: ``accuracy``, ``auc``; ``clip_by_norm``,
``squared_l2_norm``; ``print``; ``share_data`` and the ``memcpy``
family; ``coalesce_tensor``; ``beam_search`` and ``beam_search_decode``.

Counterpart of ``paddle_tpu/ops/misc.py`` ``_accuracy`` (reference
operators/metrics/accuracy_op.cc): the share of rows whose label is among
the top-k indices, with the count of such rows and of all rows; of its
``_auc`` (the batch statistic: the rank-sum form of the area under the
ROC curve, ties broken by position; float64 out); of its
``_clip_by_norm`` (reference clip_by_norm_op.h), which
``layers.clip_by_norm`` builds; of ``_print``, which writes ``message =
value`` to the host's stdout at each run (``jax.debug.print`` in the JAX
package; here a host copy, so a program holding it runs eagerly, see
``framework/executor.capture_reason``); and of ``_share_data`` (identity).

Counterpart of ``paddle_tpu/ops/misc_ops.py``'s ``select_input`` /
``select_output``, the tensor-array ops (``write_to_array``,
``read_from_array``, ``lod_array_length``, ``array_to_lod_tensor``,
``lod_tensor_to_array``: the environment holds a Python list for an
array, which the executor passes through as it is; an index tensor is
read on the host) and ``py_func`` (a registered host callable, called on
host copies of its inputs at each run: ``jax.pure_callback`` in the JAX
package; a program holding it runs eagerly).

Counterpart of its ``_squared_l2_norm`` (a float32 sum, shape [1]: the
reference's global-norm clip sums one per gradient), ``_coalesce_tensor``
(the values pass through and ``FusedOutput`` is their raveled
concatenation, as in the JAX package; not the reference's aliasing of
one buffer), ``_beam_search`` and ``_beam_search_decode`` (the JAX
package's dense redesign of beam_search_op.cc / beam_search_decode_op.cc:
rows stay [batch * beam]; a finished lane, ``pre_id == end_id``,
competes with one ``end_id`` candidate at its frozen score; the top k of
each batch's beam * C candidates come from a stable descending sort, so
a tie goes to the lower index as under ``lax.top_k``, which
``torch.topk`` on the card does not promise; ``parent_idx`` is the global
row; the decode walks the steps back with ``linalg_ops.backtrack_beams``,
as ``gather_tree`` does).
The other ops of that module live in ``math_ops`` (``increment``,
``sum``, ``clip``), ``linalg_ops`` and ``tensor_ops``, or come with later
slices of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.lowering import register_lower
from .linalg_ops import backtrack_beams


@register_lower("accuracy")
def _accuracy(ctx, op):
    pred_idx = ctx.in1(op, "Indices")  # [N, k] from top_k
    label = ctx.in1(op, "Label")  # [N, 1]
    if label.dim() == 1:
        label = label[:, None]
    correct = (pred_idx == label.to(pred_idx.dtype)).any(dim=1)
    num_correct = correct.to(torch.float32).sum()
    n = pred_idx.shape[0]
    ctx.set_out(op, "Accuracy", (num_correct / n).reshape(1))
    ctx.set_out(op, "Correct", num_correct.to(torch.int32).reshape(1))
    ctx.set_out(op, "Total", torch.full((1,), n, dtype=torch.int32,
                                        device=pred_idx.device))


@register_lower("clip_by_norm")
def _clip_by_norm(ctx, op):
    """``x`` scaled by ``max_norm / ||x||_2`` when its norm exceeds
    ``max_norm``, else unchanged."""
    x = ctx.in1(op, "X")
    max_norm = float(op.attr("max_norm"))
    norm = torch.sqrt(torch.sum(torch.square(x)))
    factor = torch.where(norm > max_norm,
                         max_norm / torch.clamp(norm, min=1e-12),
                         torch.ones_like(norm))
    ctx.set_out(op, "Out", x * factor.to(x.dtype))


@register_lower("auc")
def _auc(ctx, op):
    preds = ctx.in1(op, "Predict")
    label = ctx.in1(op, "Label")
    pos_score = preds[:, 1]
    lbl = label.squeeze(-1) if label.dim() == 2 else label
    n_pos = (lbl == 1).sum().double()
    n_neg = (lbl == 0).sum().double()
    order = torch.argsort(pos_score, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(1, pos_score.shape[0] + 1,
                               device=order.device))
    sum_pos_ranks = torch.where(lbl == 1, ranks,
                                torch.zeros_like(ranks)).sum().double()
    auc = (sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / torch.clamp_min(
        n_pos * n_neg, 1)
    ctx.set_out(op, "AUC", auc.reshape(1))


@register_lower("print")
def _print(ctx, op):
    x = ctx.in1(op, "In")
    message = op.attr("message", op.input("In")[0])
    host = x.detach().cpu()
    if host.dtype == torch.bfloat16:
        host = host.float()
    print(f"{message} = {np.asarray(host)}", flush=True)
    ctx.set_out(op, "Out", x)


@register_lower("squared_l2_norm")
def _squared_l2_norm(ctx, op):
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", torch.sum(torch.square(x.float())).reshape(1))


@register_lower("coalesce_tensor")
def _coalesce_tensor(ctx, op):
    names = op.inputs.get("Input", [])
    for name_in, name_out in zip(names, op.outputs.get("Output", [])):
        ctx.set(name_out, ctx.get(name_in))
    fused = op.outputs.get("FusedOutput")
    if fused:
        vals = [ctx.get(n).reshape(-1) for n in names]
        ctx.set(fused[0], torch.cat(vals) if vals
                else torch.zeros((0,), device=ctx.device))


BEAM_NEG = -1e9     # the score of a finished lane's other candidates


@register_lower("beam_search")
def _beam_search(ctx, op):
    """One selection step.  pre_ids / pre_scores [B*K, 1], scores
    [B*K, C] (accumulated log-probabilities, or probabilities when
    ``is_accumulated`` is false), ids [B*K, C] (optional: candidate j is
    token j) -> selected_ids / selected_scores [B*K, 1], parent_idx [B*K]
    (int32, as the JAX rule gives them)."""
    pre_ids = ctx.in1(op, "pre_ids")
    pre_scores = ctx.in1(op, "pre_scores")
    scores = ctx.in1(op, "scores")
    ids = ctx.in1(op, "ids")
    k = int(op.attr("beam_size"))
    end_id = int(op.attr("end_id"))
    bk, c = scores.shape
    if bk % k:
        raise ValueError(
            f"beam_search rows {bk} not divisible by beam_size {k}")
    b, dev = bk // k, scores.device
    if ids is None:
        ids = torch.arange(c, dtype=torch.int32, device=dev).expand(bk, c)
    ids = ids.to(torch.int32)
    pre_s = pre_scores.reshape(bk).float()
    acc = scores.float() if bool(op.attr("is_accumulated", True)) \
        else pre_s[:, None] + torch.log(torch.clamp_min(scores.float(),
                                                        1e-30))
    finished = (pre_ids.reshape(bk) == end_id)[:, None]
    only_end = torch.cat([torch.zeros(1, device=dev), torch.full(
        (c - 1,), BEAM_NEG, dtype=torch.float32, device=dev)])
    acc = torch.where(finished, pre_s[:, None] + only_end, acc)
    ids = ids.masked_fill(finished, end_id)
    top_scores, top_idx = torch.sort(acc.reshape(b, k * c), dim=1,
                                     descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    sel_ids = torch.gather(ids.reshape(b, k * c), 1, top_idx)
    parent = (torch.arange(b, device=dev)[:, None] * k
              + torch.div(top_idx, c, rounding_mode="floor"))
    ctx.set_out(op, "selected_ids", sel_ids.reshape(bk, 1))
    ctx.set_out(op, "selected_scores", top_scores.reshape(bk, 1))
    ctx.set_out(op, "parent_idx", parent.to(torch.int32).reshape(bk))


@register_lower("beam_search_decode")
def _beam_search_decode(ctx, op):
    """Ids / ParentIdx [T, B*K] (each step's tokens and global parent
    rows, as ``beam_search`` gives them), Scores [T, B*K] ->
    SentenceIds [B*K, T] (each final lane's path) and SentenceScores
    [B*K] (its last score)."""
    ids = ctx.in1(op, "Ids").to(torch.int32)
    parents = ctx.in1(op, "ParentIdx").long()
    k = int(op.attr("beam_size"))
    t, bk = ids.shape
    sent = backtrack_beams(ids.reshape(t, bk // k, k),
                           (parents % k).reshape(t, bk // k, k))
    ctx.set_out(op, "SentenceIds", sent.reshape(t, bk).transpose(0, 1))
    ctx.set_out(op, "SentenceScores", ctx.in1(op, "Scores")[t - 1]
                .reshape(bk))


@register_lower("share_data", "memcpy", "memcpy_h2d", "memcpy_d2h")
def _share_data(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


@register_lower("select_input")
def _select_input(ctx, op):
    xs = ctx.in_list(op, "X")
    mask = ctx.in1(op, "Mask").reshape(()).to(torch.int32)
    out = xs[0]
    for i, x in enumerate(xs[1:], start=1):
        out = torch.where(mask == i, x, out)
    ctx.set_out(op, "Out", out)


@register_lower("select_output")
def _select_output(ctx, op):
    x = ctx.in1(op, "X")
    mask = ctx.in1(op, "Mask").reshape(()).to(torch.int32)
    for i, name in enumerate(op.outputs.get("Out", [])):
        # each branch output gets x where selected, zeros otherwise (the
        # consuming conditional_block reads only the live branch)
        ctx.set(name, torch.where(mask == i, x, torch.zeros_like(x)))


def _host_index(ctx, op) -> int:
    return int(ctx.in1(op, "I").reshape(-1)[0].item())


@register_lower("write_to_array")
def _write_to_array(ctx, op):
    x = ctx.in1(op, "X")
    i = _host_index(ctx, op)
    name = op.outputs["Out"][0]
    arr = list(ctx.env.get(name, []))
    while len(arr) <= i:
        arr.append(None)
    arr[i] = x
    ctx.set(name, arr)


@register_lower("read_from_array")
def _read_from_array(ctx, op):
    arr = ctx.get(op.inputs["X"][0])
    ctx.set_out(op, "Out", arr[_host_index(ctx, op)])


@register_lower("lod_array_length")
def _lod_array_length(ctx, op):
    arr = ctx.get(op.inputs["X"][0])
    ctx.set_out(op, "Out", torch.tensor([len(arr)], dtype=torch.int64,
                                        device=ctx.device))


@register_lower("array_to_lod_tensor")
def _array_to_lod_tensor(ctx, op):
    arr = ctx.get(op.inputs["X"][0])
    ctx.set_out(op, "Out", torch.cat([torch.atleast_1d(a) for a in arr],
                                     dim=0))


@register_lower("lod_tensor_to_array")
def _lod_tensor_to_array(ctx, op):
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", [x[i] for i in range(x.shape[0])])


_PY_FUNCS = {}


def register_py_func(fid, fn):
    _PY_FUNCS[fid] = fn


@register_lower("py_func")
def _py_func(ctx, op):
    """Host-side Python function embedded in the program (reference
    py_func_op): called on host copies of its inputs, its results cast to
    the output vars' declared dtypes on the device."""
    from ..framework import dtypes

    fid = int(op.attr("forward_callable_id", op.attr("func_id", -1)))
    fn = _PY_FUNCS.get(fid)
    if fn is None:
        raise NotImplementedError(
            f"py_func id {fid} is not registered in this process; call "
            f"paddle_tpu_torch.ops.misc.register_py_func")
    if torch.device(ctx.device).type == "meta":
        # the shape probe of a branch that does not run (ops/control_flow)
        raise NotImplementedError(
            "py_func needs its inputs' values, which a meta tensor does "
            "not hold")
    xs = [np.asarray(v.detach().float().cpu() if v.dtype == torch.bfloat16
                     else v.detach().cpu())
          for v in ctx.in_list(op, "X")]
    outs = fn(*xs)
    out_names = op.outputs.get("Out", [])
    if not isinstance(outs, (list, tuple)):
        outs = (outs,)
    for n, v in zip(out_names, outs):
        var = ctx.block._find_var_recursive(n)
        ctx.set(n, torch.as_tensor(np.asarray(v), device=ctx.device).to(
            dtypes.to_torch(var.dtype)))
