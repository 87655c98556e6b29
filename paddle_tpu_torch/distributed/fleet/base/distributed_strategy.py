"""DistributedStrategy: the Python facade over the strategy message.

Counterpart of ``paddle_tpu/distributed/fleet/base/distributed_strategy.py``
(reference python/paddle/distributed/fleet/base/distributed_strategy.py:101
over framework/distributed_strategy.proto:110): the same properties, the
same ``*_configs`` dict setters and their unknown-key ``ValueError``, and
``save_to_prototxt``/``load_from_prototxt``.  The message is the port's
own (``distributed_strategy_schema``), so no protobuf is needed; the text
and bytes it writes are protobuf's, and cross between the packages.
"""
from __future__ import annotations

from ... import distributed_strategy_schema as schema


def _config_to_dict(msg: schema.Message) -> dict:
    return {f.name: msg.get(f.name) for f in schema.MESSAGES[msg.name]}


def _dict_to_config(msg: schema.Message, configs: dict):
    for k, v in (configs or {}).items():
        msg.set(k, list(v) if msg.field(k).repeated else v)


def _bool_prop(name):
    def get(self):
        return self._proto.get(name)

    def set(self, v):
        self._proto.set(name, bool(v))

    return property(get, set)


def _config_prop(name):
    def get(self):
        return _config_to_dict(self._proto.get(name))

    def set(self, configs):
        _dict_to_config(self._proto.get(name), configs)

    return property(get, set)


class DistributedStrategy:
    def __init__(self):
        self._proto = schema.Message("DistributedStrategy")

    # serialization parity (reference save_to_prototxt/load_from_prototxt)
    def save_to_prototxt(self, path):
        with open(path, "w") as f:
            f.write(schema.to_text(self._proto))

    def load_from_prototxt(self, path):
        with open(path) as f:
            schema.parse_text(f.read(), self._proto)

    def serialize_to_string(self) -> bytes:
        return schema.to_bytes(self._proto)

    def parse_from_string(self, data: bytes):
        self._proto.clear()
        schema.from_bytes(data, self._proto)

    amp = _bool_prop("amp")
    recompute = _bool_prop("recompute")
    localsgd = _bool_prop("localsgd")
    dgc = _bool_prop("dgc")
    gradient_merge = _bool_prop("gradient_merge")
    lars = _bool_prop("lars")
    lamb = _bool_prop("lamb")
    pipeline = _bool_prop("pipeline")
    elastic = _bool_prop("elastic")
    auto = _bool_prop("auto")
    a_sync = _bool_prop("a_sync")
    sync_batch_norm = _bool_prop("sync_batch_norm")
    fuse_all_reduce_ops = _bool_prop("fuse_all_reduce_ops")
    fp16_allreduce = _bool_prop("fp16_allreduce")
    sharding = _bool_prop("sharding")
    tensor_parallel = _bool_prop("tensor_parallel")
    sequence_parallel = _bool_prop("sequence_parallel")

    amp_configs = _config_prop("amp_configs")
    localsgd_configs = _config_prop("localsgd_configs")
    gradient_merge_configs = _config_prop("gradient_merge_configs")
    dgc_configs = _config_prop("dgc_configs")
    lars_configs = _config_prop("lars_configs")
    lamb_configs = _config_prop("lamb_configs")
    pipeline_configs = _config_prop("pipeline_configs")
    sharding_configs = _config_prop("sharding_configs")
    a_sync_configs = _config_prop("a_sync_configs")

    # recompute config keys the message cannot hold (RecomputeConfig
    # carries only the checkpoint list): "policy" and "scan_layers", the
    # scan-over-layers extras.  Python-side only: they do not survive
    # serialize_to_string.  RecomputeMetaOptimizer stamps them onto the
    # program's optimizer ops, where LayerScanPass reads them.
    _RC_EXTRA_KEYS = ("policy", "scan_layers")

    @property
    def recompute_configs(self):
        out = _config_to_dict(self._proto.get("recompute_configs"))
        out.update(getattr(self, "_rc_extra", {}))
        return out

    @recompute_configs.setter
    def recompute_configs(self, configs):
        extra = {}
        proto_cfg = {}
        for k, v in (configs or {}).items():
            if k in self._RC_EXTRA_KEYS:
                extra[k] = v
            else:
                proto_cfg[k] = v
        _dict_to_config(self._proto.get("recompute_configs"), proto_cfg)
        if not hasattr(self, "_rc_extra"):
            self._rc_extra = {}
        self._rc_extra.update(extra)

    # tensor_parallel config keys the message cannot hold: the partition
    # rules and the (dp, mp) mesh shape.  Python-side only, as above.
    _TP_EXTRA_KEYS = ("partition_rules", "mesh_shape")

    @property
    def tensor_parallel_configs(self):
        out = _config_to_dict(self._proto.get("tensor_parallel_configs"))
        out.update(getattr(self, "_tp_extra", {}))
        return out

    @tensor_parallel_configs.setter
    def tensor_parallel_configs(self, configs):
        extra = {}
        proto_cfg = {}
        for k, v in (configs or {}).items():
            if k in self._TP_EXTRA_KEYS:
                extra[k] = v
            else:
                proto_cfg[k] = v
        _dict_to_config(self._proto.get("tensor_parallel_configs"),
                        proto_cfg)
        if not hasattr(self, "_tp_extra"):
            self._tp_extra = {}
        self._tp_extra.update(extra)

    # expert parallelism: the message predates MoE, so both knobs are
    # Python-side state only
    @property
    def expert_parallel(self):
        return bool(getattr(self, "_ep_enabled", False))

    @expert_parallel.setter
    def expert_parallel(self, v):
        self._ep_enabled = bool(v)

    @property
    def expert_parallel_configs(self):
        return dict(getattr(self, "_ep_configs", {}))

    @expert_parallel_configs.setter
    def expert_parallel_configs(self, configs):
        if not hasattr(self, "_ep_configs"):
            self._ep_configs = {}
        self._ep_configs.update(configs or {})

    @property
    def nccl_comm_num(self):
        return self._proto.get("nccl_comm_num")

    @nccl_comm_num.setter
    def nccl_comm_num(self, v):
        self._proto.set("nccl_comm_num", int(v))

    @property
    def fuse_grad_size_in_MB(self):
        """Bucket cap for the fused gradient allreduce (default 32 MB)."""
        return self._proto.get("fuse_grad_size_in_MB")

    @fuse_grad_size_in_MB.setter
    def fuse_grad_size_in_MB(self, v):
        iv = int(v)
        if iv != v or iv <= 0:
            # the field is int32 MB: truncating 0.5 -> 0 would ignore the
            # user's cap
            raise ValueError(
                f"fuse_grad_size_in_MB must be a positive whole number of "
                f"MB, got {v!r}; for sub-MB bucket caps construct "
                f"GradAllReduce(fuse_grad_size_in_MB=...) directly")
        self._proto.set("fuse_grad_size_in_MB", iv)

    def __repr__(self):
        on = [f.name for f in schema.MESSAGES["DistributedStrategy"]
              if f.kind == "bool" and self._proto.get(f.name)]
        return f"DistributedStrategy(enabled={on})"
