"""Static-graph BERT builders — BASELINE.json config 3 flagship workload.

Copy of ``paddle_tpu/text/static_models.py`` (the JAX package's
module imports no JAX); the program it builds is the same, op for op.

Role parity: the reference's transformer workload lives in
python/paddle/fluid/tests/unittests/dist_transformer.py (fluid builder
functions emitting OpDescs) and the fused attention fast path in
paddle/fluid/operators/fused/multihead_matmul_op.cu.  TPU-native: the
builder defaults to the single fused_multihead_attention op (Pallas
flash kernel for long sequences, one fused XLA composition otherwise —
see ops/fused.py); ``use_fused_attention=False`` emits the reference's
plain matmul/softmax/dropout op chain instead.  Either way the whole
encoder compiles into one executable via the Executor.

Pretraining objective matches BERT phase 1: masked-LM over a seq-length
token stream (ignore_index marks unmasked positions) + next-sentence
prediction on the [CLS] vector.
"""
from __future__ import annotations

import math

from .. import layers
from ..initializer import NormalInitializer
from ..param_attr import ParamAttr


def _dense(x, size, act=None, name=None, init_std=0.02):
    return layers.fc(
        x, size, num_flatten_dims=len(x.shape) - 1, act=act, name=name,
        param_attr=ParamAttr(initializer=NormalInitializer(0.0, init_std)))


def _attention(x, attn_mask, hidden, n_heads, dropout_prob, name,
               use_fused=True):
    """Multi-head self-attention: q/k/v projections -> scaled-dot-product
    -> output projection.  ``use_fused`` emits the single
    fused_multihead_attention op (Pallas flash kernel on TPU; note the
    fused path has no attention-probs dropout — the standard flash
    trade-off); otherwise the reference matmul/softmax/dropout chain."""
    s = int(x.shape[1])
    d = hidden // n_heads

    q = _dense(x, hidden, name=name + "_q")
    k = _dense(x, hidden, name=name + "_k")
    v = _dense(x, hidden, name=name + "_v")

    if use_fused:
        ctxv = layers.fused_multihead_attention(
            q, k, v, num_heads=n_heads, bias_qk=attn_mask,
            name=name + "_fmha")
        return _dense(ctxv, hidden, name=name + "_out")

    def split_heads(t, n):
        # [B, S, H] -> [B, heads, S, d]; 0 copies the batch dim so the
        # program shards over dp without baking the global batch size
        t = layers.reshape(t, [0, s, n_heads, d], name=n + "_r")
        return layers.transpose(t, [0, 2, 1, 3], name=n + "_t")

    q, k, v = (split_heads(t, name + sfx)
               for t, sfx in ((q, "_q"), (k, "_k"), (v, "_v")))
    # scores: [B, heads, S, S]; scale folded into the matmul (alpha)
    scores = layers.matmul(q, k, transpose_y=True, alpha=1.0 / math.sqrt(d),
                           name=name + "_qk")
    if attn_mask is not None:
        scores = layers.elementwise_add(scores, attn_mask, name=name + "_m")
    probs = layers.softmax(scores, name=name + "_sm")
    if dropout_prob:
        probs = layers.dropout(probs, dropout_prob, name=name + "_pd")
    ctxv = layers.matmul(probs, v, name=name + "_pv")  # [B, heads, S, d]
    ctxv = layers.transpose(ctxv, [0, 2, 1, 3], name=name + "_ct")
    ctxv = layers.reshape(ctxv, [0, s, hidden], name=name + "_cr")
    return _dense(ctxv, hidden, name=name + "_out")


def _encoder_layer(x, attn_mask, hidden, n_heads, ffn_size, dropout_prob,
                   name, use_fused=True):
    """Post-LN transformer layer (original BERT): attn -> add&norm ->
    ffn(gelu) -> add&norm."""
    attn = _attention(x, attn_mask, hidden, n_heads, dropout_prob,
                      name + "_attn", use_fused=use_fused)
    if dropout_prob:
        attn = layers.dropout(attn, dropout_prob, name=name + "_ad")
    x = layers.layer_norm(layers.elementwise_add(x, attn),
                          begin_norm_axis=2, name=name + "_ln1")
    ffn = _dense(x, ffn_size, act="gelu", name=name + "_ffn1")
    ffn = _dense(ffn, hidden, name=name + "_ffn2")
    if dropout_prob:
        ffn = layers.dropout(ffn, dropout_prob, name=name + "_fd")
    return layers.layer_norm(layers.elementwise_add(x, ffn),
                             begin_norm_axis=2, name=name + "_ln2")


def bert_encoder(input_ids, token_type_ids, pos_ids, attn_mask,
                 vocab_size=30522, hidden=768, n_layers=12, n_heads=12,
                 ffn_size=3072, max_pos=512, type_vocab=2,
                 dropout_prob=0.1, use_fused_attention=True):
    """BERT encoder trunk: embeddings -> N transformer layers.

    Returns the [B, S, hidden] sequence output.
    """
    emb_attr = lambda n: ParamAttr(  # noqa: E731
        name=n, initializer=NormalInitializer(0.0, 0.02))
    we = layers.embedding(input_ids, (vocab_size, hidden),
                          param_attr=emb_attr("word_embedding"))
    pe = layers.embedding(pos_ids, (max_pos, hidden),
                          param_attr=emb_attr("pos_embedding"))
    te = layers.embedding(token_type_ids, (type_vocab, hidden),
                          param_attr=emb_attr("sent_embedding"))
    emb = layers.elementwise_add(layers.elementwise_add(we, pe), te)
    emb = layers.layer_norm(emb, begin_norm_axis=2, name="emb_ln")
    if dropout_prob:
        emb = layers.dropout(emb, dropout_prob, name="emb_drop")

    y = emb
    for i in range(n_layers):
        y = _encoder_layer(y, attn_mask, hidden, n_heads, ffn_size,
                           dropout_prob, name=f"enc_{i}",
                           use_fused=use_fused_attention)
    return y


def bert_base_pretrain_program(batch_size=64, seq_len=128, vocab_size=30522,
                               hidden=768, n_layers=12, n_heads=12,
                               ffn_size=3072, dropout_prob=0.1, lr=1e-4,
                               weight_decay=0.01, max_preds_per_seq=20,
                               use_fused_attention=True):
    """Build (main, startup, feeds, loss, optimizer) for one BERT-base
    pretraining step: masked-LM + NSP, AdamW — BASELINE.json config 3.

    The MLM head gathers the masked positions FIRST and projects only
    those ~max_preds_per_seq tokens onto the vocab (the standard
    pretraining data layout: masked positions/labels/weights come from
    the data pipeline).  Projecting all B*S positions would move a
    [B,S,30522] logits tensor through HBM for a 15% use rate — on TPU
    the gather costs nothing and the vocab matmul shrinks ~6x.

    Feeds: input_ids/token_type_ids/pos_ids [B,S] int64;
    input_mask [B,1,1,S] float32 (additive: 0 keep / -1e4 pad);
    masked_flat_pos [B*P] int64 (flattened b*S+pos indices);
    masked_labels [B*P,1] int64; masked_weights [B*P,1] float32
    (1.0 real prediction / 0.0 padding); nsp_labels [B,1] int64.
    """
    from ..framework.program import Program, program_guard
    from ..optimizer import AdamWOptimizer

    n_pred = batch_size * max_preds_per_seq
    main, startup = Program(), Program()
    with program_guard(main, startup):
        input_ids = layers.data("input_ids", [batch_size, seq_len],
                                dtype="int64", append_batch_size=False)
        token_type_ids = layers.data("token_type_ids", [batch_size, seq_len],
                                     dtype="int64", append_batch_size=False)
        pos_ids = layers.data("pos_ids", [batch_size, seq_len],
                              dtype="int64", append_batch_size=False)
        input_mask = layers.data("input_mask", [batch_size, 1, 1, seq_len],
                                 dtype="float32", append_batch_size=False)
        masked_flat_pos = layers.data("masked_flat_pos", [n_pred],
                                      dtype="int64", append_batch_size=False)
        masked_labels = layers.data("masked_labels", [n_pred, 1],
                                    dtype="int64", append_batch_size=False)
        masked_weights = layers.data("masked_weights", [n_pred, 1],
                                     dtype="float32", append_batch_size=False)
        nsp_labels = layers.data("nsp_labels", [batch_size, 1],
                                 dtype="int64", append_batch_size=False)

        seq_out = bert_encoder(
            input_ids, token_type_ids, pos_ids, input_mask,
            vocab_size=vocab_size, hidden=hidden, n_layers=n_layers,
            n_heads=n_heads, ffn_size=ffn_size, dropout_prob=dropout_prob,
            use_fused_attention=use_fused_attention)

        # --- masked-LM head on gathered positions only
        flat = layers.reshape(seq_out, [batch_size * seq_len, hidden])
        picked = layers.gather(flat, masked_flat_pos)  # [B*P, hidden]
        picked.shape = (n_pred, hidden)
        mlm = _dense(picked, hidden, act="gelu", name="mlm_trans")
        mlm = layers.layer_norm(mlm, begin_norm_axis=1, name="mlm_ln")
        mlm_logits = _dense(mlm, vocab_size, name="mlm_out")  # [B*P, V]
        tok_loss = layers.softmax_with_cross_entropy(
            mlm_logits, masked_labels)  # [B*P, 1]
        tok_loss = layers.elementwise_mul(tok_loss, masked_weights)
        denom = layers.elementwise_max(
            layers.reduce_sum(masked_weights), layers.ones([1]))
        mlm_loss = layers.elementwise_div(layers.reduce_sum(tok_loss), denom)

        # --- NSP head on [CLS] (position 0): tanh pool -> 2-way
        cls = layers.slice(seq_out, axes=[1], starts=[0], ends=[1])
        cls = layers.reshape(cls, [0, hidden])
        pooled = _dense(cls, hidden, act="tanh", name="pooler")
        nsp_logits = _dense(pooled, 2, name="nsp_out")
        nsp_loss = layers.mean(
            layers.softmax_with_cross_entropy(nsp_logits, nsp_labels))

        # mean() normalizes the [1]-vs-scalar shape mix from the div chain
        loss = layers.mean(
            layers.elementwise_add(mlm_loss, nsp_loss), name="total_loss")
        opt = AdamWOptimizer(learning_rate=lr, weight_decay=weight_decay)

    feeds = (input_ids, token_type_ids, pos_ids, input_mask,
             masked_flat_pos, masked_labels, masked_weights, nsp_labels)
    return main, startup, feeds, loss, opt
