"""PyTorch port: inference export and serving
(``fluid.io.save_inference_model`` -> ``inference.Predictor``), the wire
codec of ``__model__`` (``framework/ir_wire.py``) and the variable files
(``framework/var_io.py``), held against the JAX package.

The model is slice 4's at a small width: the BERT encoder with batch dim
-1, fused attention, dropout 0, and the pretraining program's NSP head
(pooler + 2-way classifier); both packages build it, the JAX startup's
values seed both.  A model dir saved by either package loads in the
other's ``Predictor``; outputs agree within 1e-5 absolute in float32,
int8 and fp8 modes (the same carriers bit for bit, float32 summation
order over 2 layers of width 32), with the same number of rewritten ops.
The codec is held to ``ir_pb2``: the port's bytes parse to the message
``to_proto`` builds, and protobuf's bytes decode to the program
``from_proto`` builds.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jpkg
from paddle_tpu import inference as jinference
from paddle_tpu import layers as jlayers
from paddle_tpu.fluid import io as jio
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework import var_io as jvar_io
from paddle_tpu.monitor import stat_get as jstat
from paddle_tpu.text import static_models as jsm
import paddle_tpu_torch as tpkg
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.framework import ir_pb2
from paddle_tpu_torch.framework import ir_wire
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework import var_io as tvar_io
from paddle_tpu_torch.framework.scope import scope_from_numpy
from paddle_tpu_torch.monitor import stat_get as tstat
from paddle_tpu_torch.text import static_models as tsm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
S = 128
CFG = dict(vocab_size=64, hidden=32, n_layers=2, n_heads=2, ffn_size=64,
           max_pos=128)
N_QUANT_OPS = 6 * CFG["n_layers"] + 2     # every fc, pooler and nsp_out
FEED_NAMES = ["input_ids", "token_type_ids", "pos_ids", "input_mask"]
PKG = {"jax": dict(pkg=jpkg, layers=jlayers, sm=jsm, program=jprogram,
                   unique=junique, io=jio, inference=jinference,
                   stat=jstat),
       "torch": dict(pkg=tpkg, layers=tlayers, sm=tsm, program=tprogram,
                     unique=tunique, io=tio, inference=tinference,
                     stat=tstat)}


@pytest.fixture(autouse=True)
def _flags_off():
    yield
    for p in PKG.values():
        p["pkg"].set_flags({"FLAGS_weight_quant": ""})


def bert_inference_program(which):
    """The served model: encoder + [CLS] pooler + NSP logits, as
    ``text/static_models.py`` builds them, with a -1 batch dim."""
    p = PKG[which]
    layers, sm, program = p["layers"], p["sm"], p["program"]
    main, startup = program.Program(), program.Program()
    main.random_seed = 7
    with p["unique"].guard(), program.program_guard(main, startup):
        ids, tt, pos = (layers.data(n, [-1, S], dtype="int64",
                                    append_batch_size=False)
                        for n in FEED_NAMES[:3])
        mask = layers.data("input_mask", [-1, 1, 1, S], dtype="float32",
                           append_batch_size=False)
        seq = sm.bert_encoder(ids, tt, pos, mask, dropout_prob=0.0, **CFG)
        cls = layers.slice(seq, axes=[1], starts=[0], ends=[1])
        cls = layers.reshape(cls, [0, CFG["hidden"]])
        pooled = sm._dense(cls, CFG["hidden"], act="tanh", name="pooler")
        nsp = sm._dense(pooled, 2, name="nsp_out")
    return main, startup, seq, nsp


def feeds(batch, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.zeros((batch, 1, 1, S), "float32")
    mask[::2, :, :, S - 16:] = -1e4
    return {"input_ids": rng.randint(0, CFG["vocab_size"], (batch, S))
            .astype("int64"),
            "token_type_ids": rng.randint(0, 2, (batch, S)).astype("int64"),
            "pos_ids": np.tile(np.arange(S, dtype="int64"), (batch, 1)),
            "input_mask": mask}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One model dir saved by each package, from the same values."""
    root = tmp_path_factory.mktemp("models")
    jmain, jstart, jseq, jnsp = bert_inference_program("jax")
    jexe, jscope = jpkg.Executor(jpkg.CPUPlace()), jpkg.framework.Scope()
    jexe.run(jstart, scope=jscope)
    values = {n: np.asarray(jscope.get_var(n))
              for n in jscope.local_var_names()
              if jscope.get_var(n) is not None and not n.startswith("@")}
    with jpkg.fluid.scope_guard(jscope):
        jio.save_inference_model(str(root / "jax"), FEED_NAMES,
                                 [jseq, jnsp], jexe, jmain)
    tmain, _tstart, tseq, tnsp = bert_inference_program("torch")
    texe = tpkg.Executor(tpkg.CPUPlace())
    with tpkg.fluid.scope_guard(scope_from_numpy(values, device="cpu")):
        tio.save_inference_model(str(root / "torch"), FEED_NAMES,
                                 [tseq, tnsp], texe, tmain)
    return {"jax": str(root / "jax"), "torch": str(root / "torch"),
            "program": tmain, "fetch": [tseq.name, tnsp.name]}


def _predictor(which, model_dir):
    cfg = PKG[which]["inference"].Config(model_dir)
    cfg.disable_gpu()
    return PKG[which]["inference"].create_predictor(cfg)


# -- the wire codec ------------------------------------------------------


def _fc_train_program():
    from paddle_tpu_torch.optimizer import SGDOptimizer

    main, startup = tprogram.Program(), tprogram.Program()
    with tunique.guard(), tprogram.program_guard(main, startup):
        x = tlayers.data("x", [16])
        h = tlayers.fc(x, 8, act="tanh")
        loss = tlayers.mean(h)
        SGDOptimizer(learning_rate=0.1).minimize(loss)
    main.random_seed = -3
    return main


@pytest.mark.parametrize("which", ["bert_inference", "fc_train"])
def test_port_bytes_parse_with_protobuf_to_to_proto(saved, which):
    prog = saved["program"] if which == "bert_inference" \
        else _fc_train_program()
    feed, fetch = (FEED_NAMES, saved["fetch"]) if which == "bert_inference" \
        else ([], [])
    data = ir_wire.encode_program(prog, feed, fetch)
    parsed = ir_pb2.ProgramDef()
    parsed.ParseFromString(data)
    want = prog.to_proto()
    want.feed_names.extend(feed)
    want.fetch_names.extend(fetch)
    assert parsed == want
    assert prog.serialize_to_string() == ir_wire.encode_program(prog)
    back = tprogram.Program.parse_from_string(data)
    assert back.fingerprint() == tprogram.Program.from_proto(want) \
        .fingerprint()
    assert (getattr(back, "_feed_names", []), getattr(
        back, "_fetch_names", [])) == (list(feed), list(fetch))


def test_jax_bytes_decode_to_the_program_protobuf_gives(saved):
    with open(os.path.join(saved["jax"], "__model__"), "rb") as f:
        data = f.read()
    prog, feed, fetch = ir_wire.decode_program(data)
    pb = ir_pb2.ProgramDef()
    pb.ParseFromString(data)
    assert prog.fingerprint() == tprogram.Program.from_proto(pb).fingerprint()
    assert (feed, fetch) == (list(pb.feed_names), list(pb.fetch_names)) \
        == (FEED_NAMES, saved["fetch"])
    jprog = jprogram.Program.from_proto(pb)
    assert prog.fingerprint() == jprog.fingerprint()
    assert [(op.type, op.inputs, op.outputs, op.attrs)
            for op in prog.global_block.ops] == \
        [(op.type, op.inputs, op.outputs, op.attrs)
         for op in jprog.global_block.ops]


def test_every_attr_kind_round_trips_through_both_codecs():
    prog = tprogram.Program()
    blk = prog.global_block
    sub = prog._create_block()
    prog._rollback()
    blk.create_var(name="v", shape=[-1, 3, 0], dtype="int64",
                   persistable=True, stop_gradient=True)
    attrs = {"i": -5, "big": 2 ** 40, "zero": 0, "f": -2.5, "fz": 0.0,
             "s": "héllo", "empty_s": "", "b": True, "bf": False,
             "ints": [1, -2, 2 ** 35], "floats": [0.5, -1e-30, 3.0],
             "strings": ["a", ""], "bools": [True, False, True],
             "empty": []}
    blk.append_op("custom", {"X": ["v"], "Y": []}, {"Out": ["v"]}, attrs)
    sub.append_op("inner", {}, {"Out": ["w"]}, {"k": 1})
    data = prog.serialize_to_string()
    pb = ir_pb2.ProgramDef()
    pb.ParseFromString(data)
    assert pb == prog.to_proto()
    # protobuf's bytes, with the block kinds the builders never write
    pb.blocks[0].ops[0].attrs["sub"].block = 1
    pb.blocks[0].ops[0].attrs["subs"].blocks.v.extend([1, 0])
    back, _, _ = ir_wire.decode_program(pb.SerializeToString())
    (op,) = back.global_block.ops
    assert op.attrs == dict(attrs, sub=1, subs=[1, 0])
    assert op.inputs == {"X": ["v"], "Y": []}
    assert back.blocks[1].parent_idx == 0 and back.global_block \
        .parent_idx == -1
    var = back.global_block.vars["v"]
    assert (var.shape, var.dtype_str, var.persistable) == \
        ((-1, 3, 0), "int64", True)
    with pytest.raises(ValueError, match="truncated"):
        ir_wire.decode_program(data[:-3])


# -- variable files -------------------------------------------------------


def test_var_io_round_trips_and_matches_the_jax_files(tmp_path):
    import ml_dtypes

    rs = np.random.RandomState(0)
    arrays = {"f32": rs.randn(3, 4).astype("f4"),
              "i8": rs.randint(-127, 128, (5,)).astype("int8"),
              "i64": np.arange(6, dtype="int64").reshape(2, 3),
              "bf16": rs.randn(4).astype(ml_dtypes.bfloat16),
              "fp8": rs.randn(4).astype(ml_dtypes.float8_e4m3fn)}
    for name, arr in arrays.items():
        ours, theirs = tmp_path / ("t_" + name), tmp_path / ("j_" + name)
        tvar_io.save_var(arr, str(ours))
        jvar_io.save_var(arr, str(theirs))
        assert ours.read_bytes() == theirs.read_bytes()
        back = tvar_io.load_var(str(theirs))
        assert back.dtype == arr.dtype and np.array_equal(
            back.view(np.uint8), arr.view(np.uint8))
    order = sorted(arrays)
    tvar_io.save_combine(arrays, order, str(tmp_path / "t_all"))
    jvar_io.save_combine(arrays, order, str(tmp_path / "j_all"))
    assert (tmp_path / "t_all").read_bytes() == \
        (tmp_path / "j_all").read_bytes()
    back = tvar_io.load_combine(str(tmp_path / "j_all"))
    assert list(back) == order
    with pytest.raises(ValueError, match="bad magic"):
        tvar_io.load_combine(str(tmp_path / "t_f32"))
    # a host without ml_dtypes (a process that never imported it) reads
    # float32 and int8 files, and names the variable it cannot read
    script = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None
        import numpy as np
        from paddle_tpu_torch.framework import var_io
        assert var_io.load_var({str(tmp_path / "t_f32")!r}).dtype == "f4"
        assert var_io.load_var({str(tmp_path / "t_i8")!r}).dtype == "i1"
        for call in (lambda: var_io.load_combine({str(tmp_path / "j_all")!r}),
                     lambda: var_io.load_var({str(tmp_path / "t_bf16")!r})):
            try:
                call()
            except TypeError as e:
                print(e)
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 2 and "'bf16'" in lines[0] and \
        "'t_bf16'" in lines[1] and all("ml_dtypes" in x for x in lines)


# -- Predictor, across the packages -----------------------------------


@pytest.mark.parametrize("mode", ["", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("saved_by", ["jax", "torch"])
def test_predictors_agree_across_packages(saved, saved_by, mode):
    for p in PKG.values():
        p["pkg"].set_flags({"FLAGS_weight_quant": mode})
    before = {w: PKG[w]["stat"]("pass_weight_quant_ops") for w in PKG}
    f = feeds(2, seed=1)
    outs = {w: _predictor(w, saved[saved_by]).run(f) for w in PKG}
    for w in PKG:
        assert PKG[w]["stat"]("pass_weight_quant_ops") - before[w] == \
            (N_QUANT_OPS if mode else 0)
    (tseq, tnsp), (jseq, jnsp) = outs["torch"], outs["jax"]
    assert tseq.shape == (2, S, CFG["hidden"]) and tnsp.shape == (2, 2)
    np.testing.assert_allclose(tseq, np.asarray(jseq), rtol=0, atol=TOL)
    np.testing.assert_allclose(tnsp, np.asarray(jnsp), rtol=0, atol=TOL)


def test_batch_2_then_3_from_one_saved_model(saved):
    """A -1 batch dim serves any batch; the pass runs once (its cache is
    keyed by feed names, not shapes), and int8 moves the output by a
    fraction of its scale."""
    tpkg.set_flags({"FLAGS_weight_quant": "int8"})
    pred = _predictor("torch", saved["torch"])
    assert pred.get_input_names() == FEED_NAMES
    assert pred.get_output_names() == saved["fetch"]
    n0 = tstat("pass_weight_quant_ops")
    two = pred.run(feeds(2, seed=2))
    three = pred.run([feeds(3, seed=3)[n] for n in FEED_NAMES])
    assert tstat("pass_weight_quant_ops") - n0 == N_QUANT_OPS
    assert [o.shape for o in two] == [(2, S, 32), (2, 2)]
    assert [o.shape for o in three] == [(3, S, 32), (3, 2)]
    tpkg.set_flags({"FLAGS_weight_quant": ""})
    base = _predictor("torch", saved["torch"]).run(feeds(3, seed=3))
    assert np.isfinite(three[0]).all()
    assert np.abs(three[0] - base[0]).max() < \
        0.05 * np.abs(base[0]).max()


def test_config_devices_and_predictor_errors(saved):
    cfg = tinference.Config(saved["torch"])
    assert cfg.model_dir() == saved["torch"] and cfg._use_tpu
    cfg.enable_tpu(1)
    assert cfg._device_id == 1
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="CUDA"):
            tinference.create_predictor(tinference.Config(saved["torch"]))
    with pytest.raises(ValueError, match="no model dir"):
        tinference.Predictor(tinference.Config())
    pred = _predictor("torch", saved["torch"])
    f = feeds(1)
    with pytest.raises(KeyError, match="missing inputs.*input_mask"):
        pred.run({k: v for k, v in f.items() if k != "input_mask"})
    with pytest.raises(ValueError, match="expected 4 inputs"):
        pred.run([f["input_ids"]])
    assert tpkg.framework.global_scope().find_var("pooler.w_0") is None


# -- fluid.io pieces ------------------------------------------------------


def test_save_load_params_combined_and_prune_refusals(tmp_path):
    main, startup, seq, nsp = bert_inference_program("torch")
    rs = np.random.RandomState(4)
    values = {v.name: rs.randn(*v.shape).astype("f4")
              for v in main.global_block.vars.values() if v.persistable}
    exe = tpkg.Executor(tpkg.CPUPlace())
    with tpkg.fluid.scope_guard(scope_from_numpy(values, device="cpu")):
        tio.save_params(exe, str(tmp_path / "p"), main, filename="all")
        tio.save_inference_model(str(tmp_path / "m"), FEED_NAMES, [nsp],
                                 exe, main, params_filename="params")
    scope = tpkg.framework.Scope()
    with tpkg.fluid.scope_guard(scope):
        tio.load_params(exe, str(tmp_path / "p"), main, filename="all")
        prog, feed_names, fetch = tio.load_inference_model(
            str(tmp_path / "m"), exe, params_filename="params")
    for n, arr in values.items():
        assert np.array_equal(scope.get_var(n).numpy(), arr)
    assert feed_names == FEED_NAMES and [v.name for v in fetch] == \
        [nsp.name]
    assert not any(op.type == "dequant_matmul" for op in
                   prog.global_block.ops)
    # only what nsp needs is kept: the pooler reads [CLS] of the last layer
    assert len(prog.global_block.ops) < len(main.global_block.ops) + 1
    with pytest.raises(ValueError, match="not produced"):
        tio.prune_program(main, FEED_NAMES, ["no_such_var"])
    # a while whose sub-block alone reads the encoder's output: the
    # slice keeps the encoder (what the sub-block reads counts)
    ctrl = main.clone()
    blk = ctrl.global_block
    for name, dtype in (("c", "bool"), ("acc", "float32")):
        blk.create_var(name=name, dtype=dtype)
        blk.append_op("fill_constant", {}, {"Out": [name]},
                      {"shape": [1], "dtype": dtype, "value": 0.0})
    sub = ctrl._create_block()
    sub.append_op("reduce_sum", {"X": [seq.name]}, {"Out": ["acc"]},
                  {"reduce_all": True})
    ctrl._rollback()
    blk.append_op("while", {"X": ["c", "acc"], "Condition": ["c"]},
                  {"Out": ["c", "acc"]}, {"sub_block": sub.idx})
    sliced = tio.prune_program(ctrl, FEED_NAMES, ["acc"])
    kept = [op.type for op in sliced.global_block.ops]
    assert kept[-1] == "while" and "layer_norm" in kept
    assert any(seq.name in op.output_arg_names()
               for op in sliced.global_block.ops)
    assert not any(nsp.name in op.output_arg_names()
                   for op in sliced.global_block.ops)
    mixed = tprogram.Program()
    mixed.global_block.append_op("save", {"X": ["a"]}, {},
                                 {"file_path": str(tmp_path / "a")})
    mixed.global_block.append_op("mean", {"X": ["a"]}, {"Out": ["b"]})
    with pytest.raises(NotImplementedError, match="host I/O program"):
        exe.run(mixed, scope=scope_from_numpy({"a": np.ones(2, "f4")},
                                              device="cpu"))
    with pytest.raises(ValueError, match="run_steps"):
        exe.run_steps(mixed, feed={"z": np.ones((1, 2), "f4")})
