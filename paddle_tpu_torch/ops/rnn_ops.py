"""Recurrent ops: the v2 ``rnn`` op (LSTM / GRU / simple, multi-layer,
bidirectional) and the fluid-era cell and sequence ops (``gru_unit``,
``lstm_unit``, ``gru``, ``lstm`` / ``lstmp``).

Counterpart of ``paddle_tpu/ops/rnn_ops.py`` (reference
operators/rnn_op.cc, gru_unit_op.cc, lstm_unit_op.cc, gru_op.cc,
lstm_op.cc).  The JAX package runs one ``lax.scan`` per (layer,
direction); here ``rnn`` calls torch's fused recurrent ops
(``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` / ``rnn_relu``, what
``torch.nn.LSTM`` calls: cuDNN on the card, the reference's own ``rnn``
op's library).  ``_run_direction`` keeps the step-by-step recurrence as
the reference the tests hold the fused route to.  The fluid-era ops are
plain torch loops over the time steps.

WeightList layout (reference nn/layer/rnn.py flatten_parameters): all
[w_ih, w_hh] pairs for each (layer, direction) first, then all
[b_ih, b_hh] pairs in the same order; torch's fused ops take
[w_ih, w_hh, b_ih, b_hh] per (layer, direction), so the list is
reordered (no copy).  Gate order: i,f,g,o for LSTM and r,z,n
(reset-after: ``n = tanh(x_n + r * (W_hn h + b_hn))``) for GRU, the same
in cuDNN and torch.  cuDNN wants the weights as views of one buffer in
its own layout; the layer's parameters are separate tensors, so cuDNN
copies them into a scratch buffer at every call (``PERF.md`` gives the
cost).
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower

_FUSED = {"LSTM": torch._VF.lstm, "GRU": torch._VF.gru,
          "RNN_TANH": torch._VF.rnn_tanh, "RNN_RELU": torch._VF.rnn_relu}


def _lstm_cell(x_g, h, c, w_hh, b_hh):
    gates = x_g + h @ w_hh.t()
    if b_hh is not None:
        gates = gates + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.tanh(c2) * torch.sigmoid(o), c2


def _gru_cell(x_g, h, w_hh, b_hh):
    hg = h @ w_hh.t()
    if b_hh is not None:
        hg = hg + b_hh
    xr, xz, xn = x_g.chunk(3, dim=-1)
    hr, hz, hn = hg.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _run_direction(x, h0, c0, w_ih, w_hh, b_ih, b_hh, mode, reverse):
    """The step-by-step recurrence of one (layer, direction): x [T, B, I]
    time-major; returns (outs [T, B, H], hT, cT or None)."""
    if reverse:
        x = torch.flip(x, (0,))
    x_g = torch.einsum("tbi,gi->tbg", x, w_ih)   # every step's input at once
    if b_ih is not None:
        x_g = x_g + b_ih
    h, c, outs = h0, c0, []
    for t in range(x.shape[0]):
        if mode == "LSTM":
            h, c = _lstm_cell(x_g[t], h, c, w_hh, b_hh)
        elif mode == "GRU":
            h = _gru_cell(x_g[t], h, w_hh, b_hh)
        else:
            pre = x_g[t] + h @ w_hh.t()
            if b_hh is not None:
                pre = pre + b_hh
            h = torch.tanh(pre) if mode == "RNN_TANH" else torch.relu(pre)
        outs.append(h)
    outs = torch.stack(outs)
    if reverse:
        outs = torch.flip(outs, (0,))
    return outs, h, (c if mode == "LSTM" else None)


def _split_weights(weights, n_ld):
    """(the [w_ih, w_hh] pairs, the [b_ih, b_hh] pairs or Nones)."""
    has_bias = len(weights) >= 4 * n_ld
    w_pairs = list(weights[:2 * n_ld])
    b_pairs = list(weights[2 * n_ld:4 * n_ld]) if has_bias \
        else [None] * (2 * n_ld)
    return w_pairs, b_pairs, has_bias


def rnn_reference(mode, x, h0, c0, weights, num_layers, bidirectional):
    """The ``rnn`` op by ``_run_direction``, layer by layer (the JAX
    lowering's structure): (out [T, B, D*H], h_n [L*D, B, H], c_n or
    None)."""
    n_dir = 2 if bidirectional else 1
    w_pairs, b_pairs, _ = _split_weights(weights, num_layers * n_dir)
    y, hs, cs = x, [], []
    for layer in range(num_layers):
        outs = []
        for d in range(n_dir):
            ld = layer * n_dir + d
            o, hT, cT = _run_direction(
                y, h0[ld], None if c0 is None else c0[ld],
                w_pairs[2 * ld], w_pairs[2 * ld + 1],
                b_pairs[2 * ld], b_pairs[2 * ld + 1], mode, reverse=d == 1)
            outs.append(o)
            hs.append(hT)
            if cT is not None:
                cs.append(cT)
        y = outs[0] if n_dir == 1 else torch.cat(outs, dim=-1)
    return y, torch.stack(hs), (torch.stack(cs) if cs else None)


def rnn_fused(mode, x, h0, c0, weights, num_layers, bidirectional):
    """The ``rnn`` op through torch's fused recurrent op (cuDNN on the
    card): the same results as ``rnn_reference``."""
    n_dir = 2 if bidirectional else 1
    n_ld = num_layers * n_dir
    w_pairs, b_pairs, has_bias = _split_weights(weights, n_ld)
    params = []
    for ld in range(n_ld):
        params += w_pairs[2 * ld:2 * ld + 2]
        if has_bias:
            params += b_pairs[2 * ld:2 * ld + 2]
    hx = [h0, c0] if mode == "LSTM" else h0
    # cuDNN keeps what its backward needs only in training mode
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, h0, c0] + params)
    res = _FUSED[mode](x, hx, params, has_bias, num_layers, 0.0, train,
                       bidirectional, False)
    if mode == "LSTM":
        return res[0], res[1], res[2]
    return res[0], res[1], None


@register_lower("rnn")
def _rnn(ctx, op):
    mode = op.attr("mode", "LSTM")
    x = ctx.in1(op, "Input")  # [T, B, I]
    pre_states = ctx.in_list(op, "PreState")
    weights = ctx.in_list(op, "WeightList")
    num_layers = int(op.attr("num_layers", 1))
    bidi = bool(op.attr("is_bidirec", False))
    h0 = pre_states[0]  # [L*D, B, H]
    c0 = pre_states[1] if mode == "LSTM" and len(pre_states) > 1 \
        else torch.zeros_like(h0)
    y, h_n, c_n = rnn_fused(mode, x, h0, c0, weights, num_layers, bidi)
    ctx.set_out(op, "Out", y)
    states = [h_n]
    if mode == "LSTM":
        states.append(c_n)
    for name, val in zip(op.outputs.get("State", []), states):
        ctx.set(name, val)
    for slot in ("Reserve", "DropoutState"):
        ctx.set_out(op, slot, torch.zeros((1,), dtype=torch.uint8,
                                          device=x.device))


@register_lower("gru_unit")
def _gru_unit(ctx, op):
    """One GRU step (reference gru_unit_op.cc): the fluid gate layout
    [update, reset, cell] over Input [B, 3H] + HiddenPrev @ Weight."""
    x = ctx.in1(op, "Input")  # [B, 3H] (x @ W_ih + b already)
    h_prev = ctx.in1(op, "HiddenPrev")
    w = ctx.in1(op, "Weight")  # [H, 3H]: [:, :2H] gates, [:, 2H:] candidate
    bias = ctx.in1(op, "Bias")
    hid = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(-1)
    gu = x[:, :2 * hid] + h_prev @ w[:, :2 * hid]
    u, r = torch.sigmoid(gu).chunk(2, dim=-1)
    c = torch.tanh(x[:, 2 * hid:] + (r * h_prev) @ w[:, 2 * hid:])
    # gru_unit_op.h: origin_mode=True -> u*h_prev + (1-u)*c; the default
    # (False) is u*c + (1-u)*h_prev (gru_kernel.h gru_finalOutput).
    if bool(op.attr("origin_mode", False)):
        h = u * h_prev + (1.0 - u) * c
    else:
        h = u * c + (1.0 - u) * h_prev
    ctx.set_out(op, "Gate", torch.cat([u, r, c], dim=-1))
    ctx.set_out(op, "ResetHiddenPrev", r * h_prev)
    ctx.set_out(op, "Hidden", h)


@register_lower("lstm_unit")
def _lstm_unit(ctx, op):
    """One LSTM step (reference lstm_unit_op.h:64-72): X [B, 4H]
    pre-gates in (i, f, o, g) chunk order, forget_bias added to f;
    C_prev [B, H]."""
    x = ctx.in1(op, "X")
    c_prev = ctx.in1(op, "C_prev")
    forget_bias = float(op.attr("forget_bias", 0.0))
    i, f, o, g = x.chunk(4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev \
        + torch.sigmoid(i) * torch.tanh(g)
    ctx.set_out(op, "C", c)
    ctx.set_out(op, "H", torch.sigmoid(o) * torch.tanh(c))


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v}


@register_lower("gru")
def _gru(ctx, op):
    """Fluid LoD gru (gru_op.cc) under dense semantics: Input [T, 3H] is
    ONE sequence of pre-projected gates (x @ W_ih + b done by the fc
    before it, the reference layers.dynamic_gru contract)."""
    x = ctx.in1(op, "Input")  # [T, 3H]
    w = ctx.in1(op, "Weight")  # [H, 3H]
    bias = ctx.in1(op, "Bias")
    h0 = ctx.in1(op, "H0")
    hid = w.shape[0]
    gate_act = _ACTS[op.attr("gate_activation", "sigmoid")]
    cand_act = _ACTS[op.attr("activation", "tanh")]
    reverse = bool(op.attr("is_reverse", False))
    origin_mode = bool(op.attr("origin_mode", False))
    if bias is not None:
        x = x + bias.reshape(-1)
    if reverse:
        x = torch.flip(x, (0,))
    h = h0 if h0 is not None else x.new_zeros((hid,))
    hidden, reset_h, gates = [], [], []
    for t in range(x.shape[0]):
        xg = x[t]
        gu = gate_act(xg[:2 * hid] + h @ w[:, :2 * hid])
        u, r = gu[:hid], gu[hid:]
        c = cand_act(xg[2 * hid:] + (r * h) @ w[:, 2 * hid:])
        rh = r * h
        h = u * h + (1.0 - u) * c if origin_mode else u * c + (1.0 - u) * h
        hidden.append(h)
        reset_h.append(rh)
        gates.append(gu)
    hidden = torch.stack(hidden)
    if reverse:
        hidden = torch.flip(hidden, (0,))
    gates = torch.stack(gates)
    ctx.set_out(op, "Hidden", hidden)
    ctx.set_out(op, "BatchGate", torch.cat(
        [gates, gates.new_zeros((x.shape[0], hid))], dim=-1)[:, :3 * hid])
    ctx.set_out(op, "BatchResetHiddenPrev", torch.stack(reset_h))
    ctx.set_out(op, "BatchHidden", hidden)


@register_lower("lstm", "lstmp")
def _lstm(ctx, op):
    """Fluid LoD lstm / lstmp (lstm_op.cc) under single-sequence dense
    semantics: Input [T, 4H] pre-projected gates; lstmp adds a recurrent
    projection ProjWeight [H, P]."""
    x = ctx.in1(op, "Input")  # [T, 4H]
    w = ctx.in1(op, "Weight")  # [H or P, 4H]
    bias = ctx.in1(op, "Bias")
    h0 = ctx.in1(op, "H0")
    c0 = ctx.in1(op, "C0")
    proj = ctx.in1(op, "ProjWeight") if op.type == "lstmp" else None
    hid = x.shape[-1] // 4
    use_peepholes = bool(op.attr("use_peepholes", False))
    reverse = bool(op.attr("is_reverse", False))
    gate_act = _ACTS[op.attr("gate_activation", "sigmoid")]
    cell_act = _ACTS[op.attr("cell_activation", "tanh")]
    cand_act = _ACTS[op.attr("candidate_activation", "tanh")]
    peep = None
    if bias is not None:
        b = bias.reshape(-1)
        x = x + b[:4 * hid]
        if use_peepholes and b.shape[0] > 4 * hid:
            peep = b[4 * hid:]
    if reverse:
        x = torch.flip(x, (0,))
    h = h0 if h0 is not None else x.new_zeros((w.shape[0],))
    c = c0 if c0 is not None else x.new_zeros((hid,))
    hidden, cell = [], []
    for t in range(x.shape[0]):
        i, f, cc, o = (x[t] + h @ w).chunk(4, dim=-1)
        if peep is not None:
            wic, wfc, woc = peep.chunk(3)
            i = i + wic * c
            f = f + wfc * c
        c = gate_act(f) * c + gate_act(i) * cand_act(cc)
        if peep is not None:
            o = o + woc * c
        h = gate_act(o) * cell_act(c)
        if proj is not None:
            h = h @ proj
        hidden.append(h)
        cell.append(c)
    hidden, cell = torch.stack(hidden), torch.stack(cell)
    if reverse:
        hidden, cell = torch.flip(hidden, (0,)), torch.flip(cell, (0,))
    ctx.set_out(op, "Hidden", hidden)
    ctx.set_out(op, "Cell", cell)
    if op.type == "lstmp":
        ctx.set_out(op, "Projection", hidden)
    ctx.set_out(op, "BatchGate", torch.zeros_like(x))
    ctx.set_out(op, "BatchCellPreAct", torch.zeros_like(cell))
