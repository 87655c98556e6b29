"""PyTorch port: ``DistributedStrategy`` without protobuf, its prototxt
and bytes crossing both ways, the role makers and ``parallel_env`` at one
process, each against the JAX package (``test_torch_fleet_chain.py``
holds ``compile_strategy`` and the ``fleet`` facade).

The strategy's message (``distributed_strategy_schema``) is pinned field
by field to the JAX package's protobuf descriptor; a strategy with every
config set writes the same text and the same bytes in both packages.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.distributed import distributed_strategy_pb2 as jpb
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch.distributed import distributed_strategy_schema as schema
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import parallel_env as tenv

_KINDS = {8: "bool", 5: "int32", 2: "float", 9: "string", 11: None}
BOOLS = ["amp", "recompute", "localsgd", "dgc", "gradient_merge", "lars",
         "lamb", "pipeline", "elastic", "auto", "a_sync", "sync_batch_norm",
         "fuse_all_reduce_ops", "fp16_allreduce", "sharding",
         "tensor_parallel", "sequence_parallel"]
CONFIGS = ["amp_configs", "recompute_configs", "localsgd_configs",
           "gradient_merge_configs", "dgc_configs", "lars_configs",
           "lamb_configs", "pipeline_configs", "sharding_configs",
           "a_sync_configs", "tensor_parallel_configs"]


def test_schema_matches_the_proto_descriptor():
    def repeated(f):
        is_rep = getattr(f, "is_repeated", None)
        return is_rep if is_rep is not None else f.label == 3

    want = {}
    for name, desc in jpb.DESCRIPTOR.message_types_by_name.items():
        want[name] = [(f.name, f.number,
                       _KINDS[f.type] or f.message_type.name,
                       None if f.type == 11 or repeated(f)
                       else f.default_value, repeated(f))
                      for f in desc.fields]
    got = {name: [(f.name, f.number, f.kind,
                   None if f.repeated or f.kind not in _KINDS.values()
                   else (schema._float32(f.default) if f.kind == "float"
                         else f.default), f.repeated) for f in fields]
           for name, fields in schema.MESSAGES.items()}
    assert got == want


def test_defaults_match_jax():
    j, t = jfleet.DistributedStrategy(), tfleet.DistributedStrategy()
    for b in BOOLS + ["nccl_comm_num", "fuse_grad_size_in_MB"]:
        assert getattr(t, b) == getattr(j, b), b
    for c in CONFIGS:
        assert getattr(t, c) == getattr(j, c), c
    assert repr(t) == repr(j)


def _everything(fleet):
    s = fleet.DistributedStrategy()
    for b in ("amp", "recompute", "gradient_merge", "dgc", "lamb",
              "fp16_allreduce", "sync_batch_norm"):
        setattr(s, b, True)
    s.fuse_all_reduce_ops = False
    s.nccl_comm_num = 2
    s.fuse_grad_size_in_MB = 64
    s.amp_configs = {"init_loss_scaling": 1024.0, "incr_every_n_steps": 500,
                     "decr_every_n_nan_or_inf": 3, "incr_ratio": 3.0,
                     "decr_ratio": 0.3, "use_dynamic_loss_scaling": False,
                     "custom_white_list": ["matmul", "mul"],
                     "custom_black_list": ["softmax"], "use_bf16": False}
    s.recompute_configs = {"checkpoints": [
        "enc_0_ln2.tmp_0", 'odd "name"\\with\ttab', "layer\u00e9"]}
    s.localsgd_configs = {"k_steps": 4, "begin_step": 2}
    s.gradient_merge_configs = {"k_steps": 4, "avg": False}
    s.dgc_configs = {"rampup_begin_step": 2, "rampup_step": 3,
                     "sparsity": [0.75, 0.9375, 0.999]}
    s.lars_configs = {"lars_coeff": 0.002, "lars_weight_decay": 1e-5,
                      "epsilon": 1e-9,
                      "exclude_from_weight_decay": ["bias", "ln"]}
    s.lamb_configs = {"lamb_weight_decay": 0.02,
                      "exclude_from_weight_decay": ["b_0"]}
    s.pipeline_configs = {"micro_batch": 4, "accumulate_steps": 2}
    s.sharding_configs = {"fuse_broadcast_MB": 16.5, "sharding_degree": 2}
    s.a_sync_configs = {"k_steps": 8, "send_queue_size": 32,
                        "independent_recv_thread": True}
    s.tensor_parallel_configs = {"tensor_parallel_degree": 2,
                                 "tensor_parallel_seed": -7}
    return s


def test_a_full_strategy_writes_the_same_text_and_bytes(tmp_path):
    j, t = _everything(jfleet), _everything(tfleet)
    j.save_to_prototxt(str(tmp_path / "j.prototxt"))
    t.save_to_prototxt(str(tmp_path / "t.prototxt"))
    jt = (tmp_path / "j.prototxt").read_text()
    assert (tmp_path / "t.prototxt").read_text() == jt
    assert "amp_configs {" in jt and "checkpoints:" in jt
    assert t.serialize_to_string() == j.serialize_to_string()
    for c in CONFIGS:
        assert getattr(t, c) == getattr(j, c), c


def test_prototxt_crosses_both_ways(tmp_path):
    path = str(tmp_path / "s.prototxt")
    _everything(jfleet).save_to_prototxt(path)
    t = tfleet.DistributedStrategy()
    t.load_from_prototxt(path)
    _everything(tfleet).save_to_prototxt(path + ".t")
    j = jfleet.DistributedStrategy()
    j.load_from_prototxt(path + ".t")
    for s in (t, j):
        ref = _everything(jfleet)
        for b in BOOLS:
            assert getattr(s, b) == getattr(ref, b), b
        for c in CONFIGS:
            assert getattr(s, c) == getattr(ref, c), c


def test_bytes_cross_both_ways():
    data = _everything(jfleet).serialize_to_string()
    t = tfleet.DistributedStrategy()
    t.amp_configs = {"use_bf16": True}      # replaced by the parse
    t.parse_from_string(data)
    assert t.serialize_to_string() == data
    j = jfleet.DistributedStrategy()
    j.parse_from_string(_everything(tfleet).serialize_to_string())
    assert j.serialize_to_string() == data


def test_the_reader_takes_protobuf_text_variants(tmp_path):
    text = ('# a comment\namp: true recompute: 1\n'
            'amp_configs: { use_bf16: false init_loss_scaling: 8.0f }\n'
            'recompute_configs < checkpoints: ["a", \'b\']\n'
            '  checkpoints: "c\\101\\x42" >\n'
            'dgc_configs { sparsity: [0.5, 0.25]; rampup_step: -3 }\n'
            'sharding_configs { fuse_broadcast_MB: inf }\n')
    path = tmp_path / "v.prototxt"
    path.write_text(text)
    t, j = tfleet.DistributedStrategy(), jfleet.DistributedStrategy()
    t.load_from_prototxt(str(path))
    j.load_from_prototxt(str(path))
    assert t.serialize_to_string() == j.serialize_to_string()
    assert t.recompute_configs["checkpoints"] == ["a", "b", "cAB"]


@pytest.mark.parametrize("p", [jfleet, tfleet], ids=["jax", "port"])
def test_config_setters_refuse_unknown_keys_and_wrong_types(p):
    s = p.DistributedStrategy()
    with pytest.raises(ValueError, match="unknown config key 'k_step' for "
                                         "GradientMergeConfig"):
        s.gradient_merge_configs = {"k_step": 2}
    with pytest.raises(TypeError):
        s.gradient_merge_configs = {"k_steps": 2.5}
    with pytest.raises(ValueError, match="fuse_grad_size_in_MB"):
        s.fuse_grad_size_in_MB = 0.5
    s.recompute_configs = {"checkpoints": ["x"], "policy": "nothing_saveable"}
    assert s.recompute_configs == {"checkpoints": ["x"],
                                   "policy": "nothing_saveable"}
    s.lars_configs = {"lars_coeff": 0.1}
    assert s.lars_configs["lars_coeff"] == np.float32(0.1)


def test_role_makers(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "127.0.0.1:6170")
    from paddle_tpu.distributed.fleet.base import role_maker as jrm
    from paddle_tpu_torch.distributed.fleet.base import role_maker as trm

    for rm in (jrm, trm):
        r = rm.PaddleCloudRoleMaker(is_collective=True)
        assert (r._worker_index(), r._worker_num(), r._is_worker(),
                r._is_first_worker(), r._get_trainer_endpoints()) == \
            (0, 1, True, True, ["127.0.0.1:6170"])
        assert r._barrier() is None and r._all_gather(3) == [3]
        u = rm.UserDefinedRoleMaker(current_id=0, worker_num=1,
                                    role=rm.Role.SERVER)
        assert u._is_server() and not u._is_worker()
    # several workers cross the process group (tests/
    # test_torch_multiprocess.py); without one they raise, naming it
    big = trm.UserDefinedRoleMaker(current_id=1, worker_num=4)
    with pytest.raises(RuntimeError, match="needs the process group"):
        big._barrier()
    with pytest.raises(RuntimeError, match="needs the process group"):
        big._all_gather(1)


def test_parallel_env_at_one_process(monkeypatch):
    monkeypatch.delenv("PADDLE_TRAINERS_NUM", raising=False)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    tenv.reset_mesh()
    assert tenv.init_parallel_env() is None
    assert tenv.init_parallel_env(mesh_shape=[1]) is None
    # a difference by design: the JAX package builds a one-device Mesh
    assert tenv.get_mesh() is None
    assert (tenv.get_world_size(), tenv.get_rank()) == (1, 3)
    assert T.distributed.get_rank() == J.distributed.get_rank() == 3
    env = T.distributed.ParallelEnv()
    assert (env.rank, env.world_size, env.nranks, env.device_id) == \
        (3, 1, 1, 0)
    one = type("OneDevice", (), {"size": 1})()
    assert tenv.set_mesh(one, ring_axes={0: "dp"}) is one
    assert tenv.get_mesh() is one and tenv.ring_axes() == {0: "dp"}
    tenv.reset_mesh()
    assert tenv.get_mesh() is None and tenv.ring_axes() == {}


@pytest.mark.parametrize("ask", ["trainers", "mesh_shape", "set_mesh",
                                 "pp_degree", "ep_degree"])
def test_parallel_env_refuses_more_than_one_device(ask, monkeypatch):
    from paddle_tpu_torch.framework import flags

    tenv.reset_mesh()
    if ask == "trainers":
        # several processes start a process group (tests/
        # test_torch_multiprocess.py): without a rendezvous it cannot,
        # and the error names the variables to set
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.delenv("PADDLE_COORDINATOR", raising=False)
        monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS", raising=False)
        with pytest.raises(ValueError, match="PADDLE_COORDINATOR"):
            tenv.init_parallel_env()
        assert not tenv.group_live() and tenv.get_mesh() is None
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 8"):
        if ask == "mesh_shape":
            tenv.init_parallel_env(mesh_shape=[2, 1])
        elif ask == "set_mesh":
            tenv.set_mesh(type("Mesh", (), {"size": 8})())
        else:
            flags.set_flags({ask: 2})
            try:
                tenv.init_parallel_env()
            finally:
                flags.set_flags({ask: 0})
    assert tenv.get_mesh() is None
