"""RNN layer classes: SimpleRNN / LSTM / GRU over the fused ``rnn`` op.

Counterpart of ``paddle_tpu/nn/layer/rnn.py`` (reference
python/paddle/nn/layer/rnn.py RNNBase:1000, whose cuDNN path emits the
``rnn`` op with a flat WeightList).  The op runs torch's fused recurrent
op (``ops/rnn_ops.py``); the parameters keep the JAX package's names
(``_flat_w_{i}``, the WeightList order), so state dicts carry across.

A static program gives the 2.0 layers' outputs no shape, so a layer that
reads its input's batch size (the zero initial state) raises there,
naming the shape it lacks; the JAX package fails at the same place with
an ``IndexError``.  Static text models are left for later (ROADMAP.md,
"static text models"): porting them would add what the JAX package
lacks.
"""
from __future__ import annotations

import numpy as np
import torch

from ...dispatch import op_call
from ...dygraph.layers import Layer
from ...dygraph.tensor import Tensor

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def known_shape(x, rank, who):
    """``x``'s shape, which must have at least ``rank`` dims: a static
    program's 2.0 outputs carry none, and then this raises."""
    shape = list(x.shape)
    if len(shape) < rank:
        raise NotImplementedError(
            f"{who}: input {getattr(x, 'name', '?')!r} has no known shape "
            f"({shape}, {rank} dims needed): the 2.0 layers' outputs in a "
            "static program carry none; static text models are left for "
            "later, as the JAX package's static adapter stops here too "
            "(ROADMAP.md, static text models)")
    return shape


class RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if mode not in _GATES:
            raise ValueError(f"unknown rnn mode {mode!r}")
        if direction == "forward":
            self._n_dir = 1
        elif direction in ("bidirect", "bidirectional"):
            self._n_dir = 2
        else:
            raise ValueError(f"unknown direction {direction!r}")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = float(dropout)
        g = _GATES[mode]

        # bias_*_attr=False omits BOTH bias vectors (the flat WeightList
        # layout has no hole for a lone missing bias)
        self._use_bias = bias_ih_attr is not False \
            and bias_hh_attr is not False
        ws, bs = [], []
        k = 1.0 / np.sqrt(hidden_size)
        for layer in range(num_layers):
            for _ in range(self._n_dir):
                in_sz = input_size if layer == 0 \
                    else hidden_size * self._n_dir
                ws += [self.create_parameter(
                           [g * hidden_size, in_sz], attr=weight_ih_attr,
                           default_initializer=_uniform(k)),
                       self.create_parameter(
                           [g * hidden_size, hidden_size],
                           attr=weight_hh_attr,
                           default_initializer=_uniform(k))]
                if self._use_bias:
                    bs += [self.create_parameter(
                               [g * hidden_size], attr=bias_ih_attr,
                               is_bias=True, default_initializer=_uniform(k)),
                           self.create_parameter(
                               [g * hidden_size], attr=bias_hh_attr,
                               is_bias=True, default_initializer=_uniform(k))]
        # reference WeightList layout: all [w_ih, w_hh] pairs, then all
        # [b_ih, b_hh] pairs (nn/layer/rnn.py flatten_parameters)
        for i, p in enumerate(ws + bs):
            setattr(self, f"_flat_w_{i}", p)

    @property
    def _weight_list(self):
        """The WeightList, read by name (a deep copy's own parameters)."""
        return [self._parameters[f"_flat_w_{i}"]
                for i in range(len(self._parameters))]

    def _zero_state(self, x):
        """Zeros [L*D, B, H] on the input's device, in its dtype."""
        shape = known_shape(x, 3, type(self).__name__)
        if not isinstance(x, Tensor):
            raise NotImplementedError(
                f"{type(self).__name__}: a zero initial state in a static "
                "program needs the batch size, which the 2.0 layers' static "
                "outputs do not carry; static text models are left for "
                "later (ROADMAP.md, static text models); pass "
                "initial_states")
        batch = shape[1] if self.time_major else shape[0]
        v = x._value
        return Tensor(torch.zeros(
            (self.num_layers * self._n_dir, batch, self.hidden_size),
            dtype=v.dtype, device=v.device))

    def _run_op(self, x, states, weights, n_layers, input_size):
        return op_call(
            "rnn",
            {"Input": x, "PreState": states, "WeightList": list(weights)},
            {"mode": self.mode, "hidden_size": self.hidden_size,
             "num_layers": n_layers, "is_bidirec": self._n_dir == 2,
             "input_size": input_size, "dropout_prob": 0.0},
            outs=("Out", "State"),
            out_counts={"State": 2 if self.mode == "LSTM" else 1},
        )

    def _layer_weights(self, layer):
        nd, wl = self._n_dir, self._weight_list
        ws = wl[2 * layer * nd:2 * (layer + 1) * nd]
        if self._use_bias:
            off = 2 * self.num_layers * nd
            ws = ws + wl[off + 2 * layer * nd:off + 2 * (layer + 1) * nd]
        return ws

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...tensor.manipulation import concat, transpose

        if sequence_length is not None:
            raise NotImplementedError(
                "sequence_length is not supported yet: the op runs all "
                "T steps; mask padded outputs downstream or pack "
                "sequences (silent wrong states would be worse)")
        x = inputs
        if not self.time_major:
            x = transpose(x, [1, 0, 2])  # the op wants [T, B, I]
        if initial_states is None:
            initial_states = self._zero_state(inputs)
            if self.mode == "LSTM":
                initial_states = (initial_states,
                                  self._zero_state(inputs))
        states = (list(initial_states)
                  if isinstance(initial_states, (list, tuple))
                  else [initial_states])

        if not (self.dropout > 0.0 and self.num_layers > 1
                and self.training):
            out, state = self._run_op(x, states, self._weight_list,
                                      self.num_layers, self.input_size)
        else:
            # reference semantics: dropout BETWEEN layers (not after the
            # last), one op per layer with the dropout op between them
            # (the fused op's own dropout would draw from another stream)
            from .. import functional as F

            nd = self._n_dir
            y = x
            finals = [[] for _ in states]
            for layer in range(self.num_layers):
                sub_states = [s[layer * nd:(layer + 1) * nd]
                              for s in states]
                in_sz = self.input_size if layer == 0 \
                    else self.hidden_size * nd
                y, st = self._run_op(y, sub_states,
                                     self._layer_weights(layer), 1, in_sz)
                st = st if isinstance(st, (list, tuple)) else [st]
                for i, s in enumerate(st):
                    finals[i].append(s)
                if layer < self.num_layers - 1:
                    y = F.dropout(y, p=self.dropout, training=True)
            out = y
            state = [concat(f, axis=0) for f in finals]
        if not self.time_major:
            out = transpose(out, [1, 0, 2])
        if self.mode == "LSTM":
            return out, tuple(state)
        return out, (state[0] if isinstance(state, (list, tuple)) else state)


def _uniform(k):
    from ...initializer import UniformInitializer

    return UniformInitializer(-k, k)


class SimpleRNN(RNNBase):
    """Reference paddle.nn.SimpleRNN."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        if activation not in ("tanh", "relu"):
            raise ValueError(
                f"SimpleRNN activation must be 'tanh' or 'relu', got "
                f"{activation!r}")
        mode = "RNN_RELU" if activation == "relu" else "RNN_TANH"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class LSTM(RNNBase):
    """Reference paddle.nn.LSTM."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(RNNBase):
    """Reference paddle.nn.GRU."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
