"""PyTorch port: the program IR and the builders of the static BERT.

The port's copies of the IR, the layer builders, backward, the AdamW
optimizer, the AMP rewriter and the BERT builder must emit the program
the JAX package emits: the same ops (types, slots, attributes) in the
same order and the same variables (shapes, types, flags), in the main
and the startup program, at BERT-base's full size (building only), with
fused and with unfused attention.  The port builds and clones programs
without ``google.protobuf``; where protobuf is there, ``clone()`` gives
what the proto round trip gives.
"""
import os
import subprocess
import sys
import textwrap

import pytest

from paddle_tpu.amp.static_amp import decorate as jdecorate
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.text import bert_base_pretrain_program as jbert
from paddle_tpu_torch.amp import decorate as tdecorate
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.text import bert_base_pretrain_program as tbert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDERS = {"jax": (jbert, jdecorate, jprogram, junique),
            "torch": (tbert, tdecorate, tprogram, tunique)}


def _bert(which, amp=True, **kw):
    bert, decorate, prog_mod, unique = BUILDERS[which]
    with unique.guard():
        main, startup, _feeds, loss, opt = bert(**kw)
        main.random_seed = 1
        with prog_mod.program_guard(main, startup):
            (decorate(opt, use_bf16=True) if amp else opt).minimize(loss)
    return main, startup


def _describe(prog):
    blk = prog.global_block
    ops = [(op.type, op.inputs, op.outputs, op.attrs) for op in blk.ops]
    var_s = {n: (v.shape, v.dtype, v.persistable, v.stop_gradient,
                 v.is_parameter) for n, v in blk.vars.items()}
    return len(prog.blocks), prog.random_seed, ops, var_s


@pytest.mark.parametrize("amp", [True, False], ids=["bf16_amp", "fp32"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_bert_base_program_matches_jax(fused, amp):
    kw = dict(batch_size=32, seq_len=128, max_preds_per_seq=20,
              use_fused_attention=fused)
    jmain, jstart = _bert("jax", amp, **kw)
    tmain, tstart = _bert("torch", amp, **kw)
    for j, t in ((jmain, tmain), (jstart, tstart)):
        jd, td = _describe(j), _describe(t)
        assert jd[:2] == td[:2]
        assert len(jd[2]) == len(td[2])
        for i, (a, b) in enumerate(zip(jd[2], td[2])):
            assert a == b, f"op {i}: {a[0]} vs {b[0]}"
        assert jd[3] == td[3]
    types = [op.type for op in tmain.global_block.ops]
    assert types.count("fused_multihead_attention") == (12 if fused else 0)
    assert types.count("adamw") > 100
    if fused and amp:   # the program the slice trains on the card
        start = [op.type for op in tstart.global_block.ops]
        assert len(types) == 1118
        assert (start.count("gaussian_random"),
                start.count("fill_constant")) == (79, 957)


def test_clone_equals_the_proto_round_trip():
    main, startup = _bert("torch", batch_size=2, seq_len=128, vocab_size=64,
                          hidden=128, n_layers=2, n_heads=2, ffn_size=256,
                          max_preds_per_seq=3)
    for prog in (main, startup):
        via_proto = tprogram.Program.parse_from_string(
            prog.serialize_to_string())
        for clone in (prog.clone(), via_proto.clone()):
            assert _describe(clone) == _describe(via_proto)
            assert [op.callstack for op in clone.global_block.ops] == \
                [op.callstack for op in via_proto.global_block.ops]
            assert clone.fingerprint() == via_proto.fingerprint()
    test = main.clone(for_test=True)
    assert all(op.attrs["is_test"] for op in test.global_block.ops
               if op.type == "dropout")
    assert not any(op.attrs["is_test"] for op in main.global_block.ops
                   if op.type == "dropout")


def test_port_programs_need_no_protobuf():
    """With ``google.protobuf`` unimportable, the port builds the BERT
    program, decorates and minimizes it, clones it, trains one step on
    the CPU, and serializes and parses it through its own wire codec
    (``ir_wire.py``); only ``to_proto``/``from_proto`` ask for
    protobuf."""
    script = textwrap.dedent("""
        import sys
        sys.modules["google.protobuf"] = None
        import numpy as np
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.amp import decorate
        from paddle_tpu_torch.framework.program import program_guard
        from paddle_tpu_torch.text import bert_base_pretrain_program
        main, startup, _, loss, opt = bert_base_pretrain_program(
            batch_size=2, seq_len=128, vocab_size=64, hidden=64,
            n_layers=1, n_heads=1, ffn_size=128, max_preds_per_seq=2)
        with program_guard(main, startup):
            decorate(opt, use_bf16=True).minimize(loss)
        main = main.clone()
        exe, scope = pt.Executor(pt.CPUPlace()), pt.framework.Scope()
        exe.run(startup.clone(), scope=scope)
        S = 128
        feed = {"input_ids": np.ones((2, S), "int64"),
                "token_type_ids": np.zeros((2, S), "int64"),
                "pos_ids": np.tile(np.arange(S), (2, 1)).astype("int64"),
                "input_mask": np.zeros((2, 1, 1, S), "float32"),
                "masked_flat_pos": np.array([1, 2, 130, 131], "int64"),
                "masked_labels": np.ones((4, 1), "int64"),
                "masked_weights": np.ones((4, 1), "float32"),
                "nsp_labels": np.zeros((2, 1), "int64")}
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert np.isfinite(out).all(), out
        assert not [m for m in sys.modules if m.startswith("google.protobuf")
                    and sys.modules[m] is not None]
        again = type(main).parse_from_string(main.serialize_to_string())
        assert again.fingerprint() == main.fingerprint()
        try:
            main.to_proto()
        except ImportError:
            print("OK")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "OK"


def test_port_ir_pb2_is_the_jax_package_copy():
    """Both packages load one generated module's bytes, so their message
    classes share protobuf's pool (``ir.proto`` registers once)."""
    for rel in ("framework/ir_pb2.py", "proto/ir.proto"):
        with open(os.path.join(ROOT, "paddle_tpu", rel), "rb") as f:
            theirs = f.read()
        with open(os.path.join(ROOT, "paddle_tpu_torch", rel), "rb") as f:
            assert f.read() == theirs, rel
    from paddle_tpu.framework import ir_pb2 as jpb
    from paddle_tpu_torch.framework import ir_pb2 as tpb

    assert tpb.ProgramDef.DESCRIPTOR.full_name == \
        jpb.ProgramDef.DESCRIPTOR.full_name
    main, _ = _bert("torch", batch_size=2, seq_len=128, vocab_size=64,
                    hidden=64, n_layers=1, n_heads=1, ffn_size=128,
                    max_preds_per_seq=2)
    parsed = jprogram.Program.parse_from_string(main.serialize_to_string())
    assert [op.type for op in parsed.global_block.ops] == \
        [op.type for op in main.global_block.ops]
