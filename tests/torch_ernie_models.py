"""The ERNIE-1.0 sentence-classification finetune of BASELINE config 5,
written once against either package (``p`` is ``paddle_tpu`` or
``paddle_tpu_torch``) and built through ``fleet``, at any width:

- the encoder is ``text.static_models.bert_encoder`` (gelu in the FFN,
  where ERNIE 1.0 has relu: the repo's encoder layer fixes gelu);
- the head: the first token's output, ``fc(hidden, act="tanh")`` (the
  pooler), dropout, ``fc(2)``, ``softmax_with_cross_entropy``, ``mean``;
- AdamW through ``fleet.init(is_collective=True, strategy=s)``,
  ``fleet.distributed_optimizer(opt)``, ``fleet.minimize(loss)``, with
  recompute's checkpoints at the output of every layer's ``_ln2``, as
  ERNIE's scripts set them.

``feed`` makes synthetic token ids, segment ids, key masks and labels
from a seed; ``one_device_mesh`` puts the JAX package at world size 1.
"""
import contextlib

import numpy as np


def ln2_outputs(main, n_layers):
    """The output of each encoder layer's second layer norm, in order."""
    out = []
    for i in range(n_layers):
        names = [op.outputs["Y"][0] for op in main.global_block.ops
                 if op.type == "layer_norm"
                 and op.outputs["Y"][0].startswith(f"enc_{i}_ln2")]
        assert len(names) == 1, names
        out.append(names[0])
    return out


def build(p, cfg, amp=True, recompute=True, gradient_merge=0, strategy=None,
          seed=3):
    """(main, startup, loss, strategy) for the finetune at ``cfg`` (a dict:
    batch, seq, vocab, hidden, layers, heads, ffn, max_pos, type_vocab,
    dropout, lr, weight_decay, fused)."""
    from importlib import import_module

    layers = p.layers
    fleet = import_module(p.__name__ + ".distributed.fleet")
    unique_name = import_module(p.__name__ + ".framework.unique_name")
    prog = import_module(p.__name__ + ".framework.program")
    sm = import_module(p.__name__ + ".text.static_models")
    opt_mod = import_module(p.__name__ + ".optimizer")

    b, s, h = cfg["batch"], cfg["seq"], cfg["hidden"]
    main, startup = prog.Program(), prog.Program()
    main.random_seed = seed
    with unique_name.guard(), prog.program_guard(main, startup):
        src = layers.data("src_ids", [b, s], dtype="int64",
                          append_batch_size=False)
        sent = layers.data("sent_ids", [b, s], dtype="int64",
                           append_batch_size=False)
        pos = layers.data("pos_ids", [b, s], dtype="int64",
                          append_batch_size=False)
        mask = layers.data("input_mask", [b, 1, 1, s], dtype="float32",
                           append_batch_size=False)
        labels = layers.data("labels", [b, 1], dtype="int64",
                             append_batch_size=False)
        seq_out = sm.bert_encoder(
            src, sent, pos, mask, vocab_size=cfg["vocab"], hidden=h,
            n_layers=cfg["layers"], n_heads=cfg["heads"],
            ffn_size=cfg["ffn"], max_pos=cfg["max_pos"],
            type_vocab=cfg["type_vocab"], dropout_prob=cfg["dropout"],
            use_fused_attention=cfg["fused"])
        cls = layers.slice(seq_out, axes=[1], starts=[0], ends=[1])
        cls = layers.reshape(cls, [0, h])
        pooled = sm._dense(cls, h, act="tanh", name="pooled_fc")
        if cfg["dropout"]:
            pooled = layers.dropout(pooled, cfg["dropout"], name="cls_drop")
        logits = sm._dense(pooled, 2, name="cls_out")
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, labels))
        if strategy is None:
            strategy = fleet.DistributedStrategy()
            strategy.amp = amp
            if recompute:
                strategy.recompute = True
                strategy.recompute_configs = {
                    "checkpoints": ln2_outputs(main, cfg["layers"])}
            if gradient_merge:
                strategy.gradient_merge = True
                strategy.gradient_merge_configs = {
                    "k_steps": gradient_merge, "avg": True}
        opt = opt_mod.AdamWOptimizer(learning_rate=cfg["lr"],
                                     weight_decay=cfg["weight_decay"])
        fleet.init(is_collective=True, strategy=strategy)
        fleet.distributed_optimizer(opt)
        fleet.minimize(loss)
    return main, startup, loss, strategy


def feed(cfg, seed):
    """Synthetic finetune inputs: ids over the vocabulary, two segments,
    every other sequence with its last quarter of keys padded, labels from
    the ids' parity."""
    b, s = cfg["batch"], cfg["seq"]
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg["vocab"], (b, s)).astype("int64")
    sent = np.zeros((b, s), "int64")
    sent[:, s // 2:] = 1
    mask = np.zeros((b, 1, 1, s), "float32")
    mask[::2, :, :, s - s // 4:] = -1e4
    return {"src_ids": ids, "sent_ids": sent,
            "pos_ids": np.tile(np.arange(s, dtype="int64"), (b, 1)),
            "input_mask": mask,
            "labels": (ids[:, :4].sum(1, keepdims=True) % 2).astype("int64")}


@contextlib.contextmanager
def one_device_mesh():
    """The JAX package at world size 1: a one-device 'dp' mesh, reset
    afterwards (the test process forces 8 virtual CPU devices)."""
    import jax

    from paddle_tpu.distributed import parallel_env

    parallel_env.set_mesh(jax.sharding.Mesh(
        np.array(jax.devices()[:1]), ("dp",)))
    try:
        yield
    finally:
        parallel_env.reset_mesh()


# the slice at a small size (ERNIE 1.0 is 12 x 768, vocab 18000, max_pos
# 513, seq 128, batch 32)
SMALL = dict(batch=8, seq=16, vocab=64, hidden=32, layers=2, heads=2,
             ffn=64, max_pos=18, type_vocab=2, dropout=0.0, lr=5e-3,
             weight_decay=0.01, fused=True)


def parts(p, amp=True, recompute=True, gradient_merge=0, **overrides):
    """(main, startup, [loss]) of the finetune at ``SMALL`` (with
    ``overrides``)."""
    main, startup, loss, _ = build(p, dict(SMALL, **overrides), amp=amp,
                                   recompute=recompute,
                                   gradient_merge=gradient_merge)
    return main, startup, [loss]
