"""Transformer layers (reference python/paddle/nn/layer/transformer.py).

Counterpart of ``paddle_tpu/nn/layer/transformer.py``.  The attention
core is a plain matmul and softmax, as in the JAX package: it runs no
hand-written kernel (neither SDPA nor the port's flash kernels).  The
stacks deep-copy their first layer, and a deep copy of a ``Layer`` owns
new parameters (``Parameter.__deepcopy__``) under the same state-dict
keys.  ``TransformerDecoderLayer`` takes ``cache`` and ignores it, as the
JAX layer does, so decoding runs the decoder over the whole prefix at
every step.

One difference from the JAX package: a bool attention mask (True: keep)
becomes ``(m - 1) * 1e4``.  The JAX package's conversion computes
``1e4 * (m - 1e4)`` (its ``scale`` adds the bias before scaling), an
offset of -1e8 that float32 scores cannot keep their digits beside.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ...dygraph import base
from ...dygraph.layers import Layer
from ...dygraph.tensor import Tensor
from ...tensor import linalg, manipulation, math as pmath
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm
from .rnn import known_shape


def _convert_attention_mask(attn_mask, dtype="float32"):
    """bool mask (True: keep) -> additive (m - 1) * 1e4; a float mask is
    additive already."""
    if attn_mask is None:
        return None
    if str(attn_mask.dtype).endswith("bool"):
        return pmath.scale(pmath.cast(attn_mask, dtype), 1e4, bias=-1e4)
    return attn_mask


class MultiHeadAttention(Layer):
    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout_p = dropout
        self.need_weights = need_weights
        kdim, vdim = kdim or embed_dim, vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        """[B, S, E] -> [B, H, S, D]."""
        b, s = known_shape(x, 3, "MultiHeadAttention")[:2]
        x = manipulation.reshape(x, [b, s, self.num_heads, self.head_dim])
        return manipulation.transpose(x, [0, 2, 1, 3])

    def _core_attention(self, q, k, v, attn_mask):
        scores = linalg.matmul(q, k, transpose_y=True)
        scores = pmath.scale(scores, 1.0 / np.sqrt(self.head_dim))
        if attn_mask is not None:
            scores = pmath.add(scores, attn_mask)
        weights = F.softmax(scores, axis=-1)
        if self.dropout_p:
            weights = F.dropout(weights, self.dropout_p,
                                training=self.training)
        return linalg.matmul(weights, v), weights

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            k = manipulation.concat([cache.k, k], axis=2)
            v = manipulation.concat([cache.v, v], axis=2)
            cache = type(cache)(k, v)
        out, weights = self._core_attention(
            q, k, v, _convert_attention_mask(attn_mask))
        b, s = query.shape[0], query.shape[1]
        out = manipulation.transpose(out, [0, 2, 1, 3])
        out = self.out_proj(manipulation.reshape(out, [b, s,
                                                       self.embed_dim]))
        results = [out]
        if self.need_weights:
            results.append(weights)
        if cache is not None:
            results.append(cache)
        return out if len(results) == 1 else tuple(results)

    def gen_cache(self, key, value=None, type=None):
        """An empty cache [B, H, 0, D] on ``key``'s device."""
        v = key._value
        empty = torch.zeros((v.shape[0], self.num_heads, 0, self.head_dim),
                            dtype=torch.float32, device=v.device)
        return MultiHeadAttention.Cache(Tensor(empty), Tensor(empty.clone()))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = pmath.add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = pmath.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


def _clones(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it."""
    return LayerList([layer] + [copy.deepcopy(layer)
                                for _ in range(num_layers - 1)])


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        tgt = pmath.add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = pmath.add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = pmath.add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
            self.encoder = TransformerEncoder(
                enc_layer, num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
            self.decoder = TransformerDecoder(
                dec_layer, num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] float32 on the current device: 0 on and below
        the diagonal, -1e9 above it."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=base.current_device()).tril()
        return Tensor(torch.where(keep, 0.0, -1e9).to(torch.float32))
