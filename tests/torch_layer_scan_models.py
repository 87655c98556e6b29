"""Shared models of the scan-over-layers parity tests, written once
against either package (``p`` is ``paddle_tpu`` or ``paddle_tpu_torch``).

- ``mlp(p, ...)``: the JAX package's tests/test_layer_scan.py network, a
  stack of relu fc layers (constant weights, dropout after each) and a
  regression head under Momentum; ``mlp_data()`` its inputs.
- ``bert(p, ...)``: ``text.bert_base_pretrain_program`` at 4 layers,
  hidden 32, 2 heads, FFN 64, sequence 16, batch 2, vocab 64, 3
  predictions a sequence, AdamW at lr 1e-3; ``bert_feed(seed)`` its
  feeds, one padded key.
- ``set_scan(p, on, min_layers)``: the package's layer-scan flags.
- ``init_state(p, startup)``: the package's startup values as host
  arrays (every persistable the startup wrote).
- ``train(p, main, loss, scope, feeds)``: one step a feed through the
  package's CPU executor; returns the losses and the executor.
"""
from importlib import import_module

import numpy as np

B, S, V, P = 2, 16, 64, 3
BERT_CFG = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=32, n_layers=4,
                n_heads=2, ffn_size=64, lr=1e-3, max_preds_per_seq=P)


def _m(p, name):
    return import_module(p.__name__ + "." + name)


def set_scan(p, on, min_layers=4, policy="", unroll=1):
    p.set_flags({"FLAGS_layer_scan": bool(on),
                 "FLAGS_layer_scan_min_layers": int(min_layers),
                 "FLAGS_layer_scan_policy": policy,
                 "FLAGS_layer_scan_unroll": int(unroll)})


def mlp(p, n_layers=6, width=16, in_dim=8, dropout=0.1, strategy=None,
        widths=None):
    """(main, startup, loss); ``widths`` gives each layer its own width
    (non-isomorphic layers), ``strategy`` minimizes through fleet."""
    layers = _m(p, "layers")
    prog = _m(p, "framework.program")
    unique = _m(p, "framework.unique_name")
    init = _m(p, "initializer")
    attr = _m(p, "param_attr")
    main, startup = prog.Program(), prog.Program()
    main.random_seed = 7
    with unique.guard(), prog.program_guard(main, startup):
        x = layers.data("x", [in_dim])
        y = layers.data("y", [1])
        h = x
        for i in range(n_layers):
            w = widths[i] if widths else width
            h = layers.fc(h, w, act="relu", param_attr=attr.ParamAttr(
                name=f"blk{i}.w",
                initializer=init.ConstantInitializer(0.02 * (i + 1))),
                bias_attr=attr.ParamAttr(
                    name=f"blk{i}.b",
                    initializer=init.ConstantInitializer(0.0)))
            if dropout:
                h = layers.dropout(h, dropout_prob=dropout)
        pred = layers.fc(h, 1, param_attr=attr.ParamAttr(
            name="head.w", initializer=init.ConstantInitializer(0.1)),
            bias_attr=False)
        loss = layers.mean(layers.square_error_cost(pred, y))
        opt = p.optimizer.MomentumOptimizer(0.05, 0.9)
        if strategy is not None:
            fleet = _m(p, "distributed.fleet")
            fleet.init(is_collective=True, strategy=strategy)
            fleet.distributed_optimizer(opt)
            fleet.minimize(loss)
        else:
            opt.minimize(loss)
    return main, startup, loss


def mlp_data(in_dim=8, n=16, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(n, in_dim).astype("f4"),
            "y": rs.randn(n, 1).astype("f4")}


def bert(p, dropout=0.0):
    prog = _m(p, "framework.program")
    unique = _m(p, "framework.unique_name")
    build = _m(p, "text").bert_base_pretrain_program
    with unique.guard():
        main, startup, _f, loss, opt = build(dropout_prob=dropout,
                                             **BERT_CFG)
        main.random_seed = 1
        with prog.program_guard(main, startup):
            opt.minimize(loss)
    return main, startup, loss


def bert_feed(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, S)).astype("int64")
    flat_pos = np.concatenate([b * S + rs.choice(S, P, replace=False)
                               for b in range(B)]).astype("int64")
    mask = np.zeros((B, 1, 1, S), "float32")
    mask[1, 0, 0, -1] = -1e4
    return {"input_ids": ids,
            "token_type_ids": (rs.rand(B, S) < 0.5).astype("int64"),
            "pos_ids": np.tile(np.arange(S, dtype="int64"), (B, 1)),
            "input_mask": mask, "masked_flat_pos": flat_pos,
            "masked_labels": ids.reshape(-1)[flat_pos].reshape(-1, 1),
            "masked_weights": np.ones((B * P, 1), "float32"),
            "nsp_labels": rs.randint(0, 2, (B, 1)).astype("int64")}


def init_state(p, startup):
    scope = p.framework.Scope()
    p.Executor(p.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.asarray(scope.get_var(v.name))
            for v in startup.global_block.vars.values()
            if v.persistable and scope.has_var(v.name)}


def train(p, main, loss, scope, feeds, exe=None):
    exe = exe or p.Executor(p.CPUPlace())
    out = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0]).item()) for f in feeds]
    return out, exe


def op_list(program, block_idx=0):
    """(type, inputs, outputs, attrs) of each op, placement attrs
    dropped: what two rewrites must agree on."""
    return [(op.type, dict(op.inputs), dict(op.outputs),
             {k: (list(v) if isinstance(v, tuple) else v)
              for k, v in op.attrs.items() if k != "op_device"})
            for op in program.blocks[block_idx].ops]
