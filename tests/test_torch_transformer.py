"""PyTorch port: ``nn.MultiHeadAttention``, the transformer encoder and
decoder layers and stacks and ``nn.Transformer`` against the JAX
package's, on the CPU.

Each layer is built by both packages, the JAX one's ``state_dict()``
carried into the port's (``torch_dygraph_parity.pair``: the keys of the
deep-copied stacks included), then the same seeded inputs go through
both: outputs, the inputs' gradients and every parameter's gradient.
Dropout is 0 (the packages' random streams differ).

Tolerance: float32, 1e-5 of the JAX result's largest magnitude
(``torch_dygraph_parity.RTOL``): matmuls, softmax and layer norm in
float32 in other summation orders on values of order 1, through at most
2 + 2 layers.

One difference by design: a bool attention mask is ``(m - 1) * 1e4`` in
the port; the JAX package's conversion gives ``1e4 * (m - 1e4)``, pinned
below, so bool masks are held to the JAX layer fed the port's float
mask.
"""
import copy

import numpy as np
import pytest
import torch

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, assert_close, check, pair, to_numpy)

RS = np.random.RandomState(3)
E, HEADS, B, S, S2 = 16, 4, 2, 5, 7
Q = RS.randn(B, S, E).astype("f4")
KV = RS.randn(B, S2, E).astype("f4")
KEEP = RS.rand(B, 1, S, S2) > 0.3
KEEP[..., 0] = True
FLOAT_MASK = ((KEEP.astype("f4") - 1.0) * 1e4).astype("f4")


def grads_match(jl, tl, rtol=1e-5):
    """Every parameter's gradient.  The key projection's bias adds the
    same q . b to each score of a row, which the softmax ignores: its
    gradient is 0 up to rounding on both sides, so it is held to
    ``rtol`` of the largest gradient instead."""
    pairs = [(n, to_numpy(a.grad), to_numpy(b.grad))
             for (n, a), (_, b) in zip(jl.named_parameters(),
                                       tl.named_parameters())
             if a.grad is not None or b.grad is not None]
    scale = max(np.abs(ga).max() for _, ga, _ in pairs)
    for n, ga, gb in pairs:
        if n.endswith("k_proj.bias"):
            assert max(np.abs(ga).max(), np.abs(gb).max()) <= rtol * scale
        else:
            assert_close(ga, gb, rtol, n)


@pytest.mark.parametrize("case", ["plain", "float_mask", "kdim_vdim",
                                  "need_weights"])
def test_multi_head_attention_matches_jax(case):
    kw = dict(kdim=6, vdim=3) if case == "kdim_vdim" else {}
    jl, tl = pair(lambda p: p.nn.MultiHeadAttention(
        E, HEADS, need_weights=case == "need_weights", **kw))
    if case == "kdim_vdim":
        k = RS.randn(B, S2, 6).astype("f4")
        v = RS.randn(B, S2, 3).astype("f4")
        check(jl, tl, Q, k, v)
    elif case == "float_mask":
        check(lambda q, kv: jl(q, kv, kv, J.to_tensor(FLOAT_MASK)),
              lambda q, kv: tl(q, kv, kv, T.to_tensor(FLOAT_MASK)), Q, KV)
    else:
        check(jl, tl, Q, KV, KV)
    grads_match(jl, tl)


def test_bool_mask_is_m_minus_one_times_1e4():
    """The port's bool mask equals its float mask (m - 1) * 1e4, and both
    the JAX layer fed that float mask; the JAX package's own bool
    conversion is 1e4 * (m - 1e4), pinned."""
    from paddle_tpu.nn.layer.transformer import _convert_attention_mask

    jl, tl = pair(lambda p: p.nn.MultiHeadAttention(E, HEADS))
    check(lambda q, kv: jl(q, kv, kv, J.to_tensor(FLOAT_MASK)),
          lambda q, kv: tl(q, kv, kv, T.to_tensor(KEEP)), Q, KV)
    want = to_numpy(tl(T.to_tensor(Q), T.to_tensor(KV), T.to_tensor(KV),
                       T.to_tensor(FLOAT_MASK)))
    got = to_numpy(tl(T.to_tensor(Q), T.to_tensor(KV), T.to_tensor(KV),
                      T.to_tensor(KEEP)))
    np.testing.assert_array_equal(got, want)
    jax_bool = to_numpy(_convert_attention_mask(J.to_tensor(KEEP)))
    np.testing.assert_array_equal(
        jax_bool, (1e4 * (KEEP.astype("f4") - 1e4)).astype("f4"))


def test_cache_concatenates_keys_and_values():
    """``gen_cache`` gives an empty [B, H, 0, D] cache; each call with a
    cache appends its keys and values and returns (out, cache), equal to
    the JAX package's over two calls."""
    jl, tl = pair(lambda p: p.nn.MultiHeadAttention(E, HEADS))
    outs = []
    for pkg, layer in ((J, jl), (T, tl)):
        q = pkg.to_tensor(Q)
        cache = layer.gen_cache(q)
        assert cache.k.shape == [B, HEADS, 0, E // HEADS]
        got = []
        for kv in (KV[:, :3], KV[:, 3:]):
            out, cache = layer(q, pkg.to_tensor(kv), pkg.to_tensor(kv),
                               None, cache)
            got.append(to_numpy(out))
        assert cache.k.shape == [B, HEADS, S2, E // HEADS]
        outs.append(got + [to_numpy(cache.k), to_numpy(cache.v)])
    for a, b in zip(*outs):
        assert_close(a, b)
    assert tl.gen_cache(T.to_tensor(Q)).k._value.device.type == "cpu"


def _layer_pair(kind, normalize_before):
    cls = "TransformerEncoderLayer" if kind == "encoder" \
        else "TransformerDecoderLayer"
    return pair(lambda p: getattr(p.nn, cls)(
        E, HEADS, 32, dropout=0.0, normalize_before=normalize_before))


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layers_match_jax(kind, normalize_before):
    """One encoder or decoder layer, post- and pre-norm, with a float
    self-attention mask (and, decoding, a cross-attention mask)."""
    jl, tl = _layer_pair(kind, normalize_before)
    self_mask = ((np.tril(np.ones((S, S))) - 1) * 1e4).astype("f4")
    if kind == "encoder":
        check(lambda x: jl(x, J.to_tensor(self_mask)),
              lambda x: tl(x, T.to_tensor(self_mask)), Q)
    else:
        check(lambda x, m: jl(x, m, J.to_tensor(self_mask),
                              J.to_tensor(FLOAT_MASK)),
              lambda x, m: tl(x, m, T.to_tensor(self_mask),
                              T.to_tensor(FLOAT_MASK)), Q, KV)
    grads_match(jl, tl)


def test_transformer_forward_and_gradients():
    """A 2 + 2-layer ``nn.Transformer`` under a causal decoder mask:
    the output, the inputs' gradients and all 84 parameters'."""
    jl, tl = pair(lambda p: p.nn.Transformer(
        E, HEADS, 2, 2, 32, dropout=0.0))
    assert len(tl.parameters()) == len(jl.parameters()) == 84
    jm = jl.generate_square_subsequent_mask(S)
    tm = tl.generate_square_subsequent_mask(S)
    check(lambda s, t: jl(s, t, tgt_mask=jm),
          lambda s, t: tl(s, t, tgt_mask=tm), KV, Q)
    grads_match(jl, tl)


def test_square_subsequent_mask():
    """0 on and below the diagonal, -1e9 above, float32, on the current
    device; equal to the JAX package's."""
    m = T.nn.Transformer(E, HEADS, 1, 1, 32).generate_square_subsequent_mask(6)
    assert m._value.dtype == torch.float32
    assert m._value.device.type == "cpu"
    want = J.nn.Transformer(E, HEADS, 1, 1, 32) \
        .generate_square_subsequent_mask(6)
    np.testing.assert_array_equal(to_numpy(m), to_numpy(want))
    assert to_numpy(m)[0, 1] == np.float32(-1e9) and to_numpy(m)[1, 1] == 0


def test_deep_copied_stacks_own_their_parameters():
    """The stacks' layers (deep copies of the first) hold parameters of
    their own: other objects, other storage, other names; the state-dict
    keys are the JAX package's; training one layer leaves the others."""
    layer = T.nn.TransformerEncoderLayer(E, HEADS, 32, dropout=0.0)
    enc = T.nn.TransformerEncoder(layer, 3)
    jenc = J.nn.TransformerEncoder(
        J.nn.TransformerEncoderLayer(E, HEADS, 32, dropout=0.0), 3)
    assert list(enc.state_dict()) == list(jenc.state_dict())
    ps = enc.parameters()
    assert len(ps) == 3 * len(layer.parameters())
    assert len({id(p) for p in ps}) == len(ps)
    assert len({p._value.data_ptr() for p in ps}) == len(ps)
    assert len({p.name for p in ps}) == len(ps)
    w0 = enc.layers[0].linear1.weight
    w1 = enc.layers[1].linear1.weight
    np.testing.assert_array_equal(to_numpy(w0), to_numpy(w1))
    before = to_numpy(w1).copy()
    with torch.no_grad():
        w0._value.add_(1.0)
    np.testing.assert_array_equal(to_numpy(w1), before)
    assert w1._value.is_leaf and w1._value.requires_grad
    clone = copy.deepcopy(w0)
    assert clone.name != w0.name and clone._value is not w0._value
