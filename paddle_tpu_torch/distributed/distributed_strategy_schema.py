"""The messages of ``distributed_strategy.proto``, without protobuf.

Counterpart of ``paddle_tpu/distributed/distributed_strategy_pb2.py``,
which needs ``google.protobuf``; the hosts the port runs on need not have
it.  Each message of the proto (proto2) is written out here as a list of
fields: name, number, kind (``bool``, ``int32``, ``float``, ``string`` or
a message name), proto2 default and whether it is repeated.  A
``Message`` holds the values of one message with proto2 presence: a
singular field that was never set reads its default and is left out of
both encodings; a nested message is present once any of its fields is.

Two encodings, limited to these messages:

- protobuf's text format (``to_text`` / ``parse_text``), what
  ``DistributedStrategy.save_to_prototxt`` writes: the fields that are
  present, in field-number order, a nested message as ``name {`` with its
  fields indented two spaces and ``}``, a repeated field one line a
  value, floats in their shortest form that reads back to the same
  float32 value, strings quoted with protobuf's C escapes (UTF-8 text
  left as it is).  The reader
  also takes ``name: { ... }``, ``< ... >``, ``[a, b]`` lists and ``#``
  comments.
- the binary wire format (``to_bytes`` / ``from_bytes``): proto2 keys and
  values, repeated fields unpacked (the decoder takes packed runs too),
  unknown fields skipped.

The two are the bytes and text that protobuf writes for
``distributed_strategy.proto``, so a strategy crosses between the
packages either way.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List, NamedTuple

from ..framework.ir_wire import (_I32, _I64, _LEN, _VARINT, _fields, _key,
                                 _len, _read_varint, _signed, _varint)


class Field(NamedTuple):
    name: str
    number: int
    kind: str                # "bool" | "int32" | "float" | "string" | message
    default: object = None
    repeated: bool = False


_SCALARS = ("bool", "int32", "float", "string")


def _f(name, number, kind, default=None):
    return Field(name, number, kind, default, False)


def _r(name, number, kind):
    return Field(name, number, kind, None, True)


MESSAGES: Dict[str, List[Field]] = {
    "RecomputeConfig": [_r("checkpoints", 1, "string")],
    "AMPConfig": [
        _f("init_loss_scaling", 1, "float", 32768.0),
        _f("incr_every_n_steps", 2, "int32", 1000),
        _f("decr_every_n_nan_or_inf", 3, "int32", 2),
        _f("incr_ratio", 4, "float", 2.0),
        _f("decr_ratio", 5, "float", 0.8),
        _f("use_dynamic_loss_scaling", 6, "bool", True),
        _r("custom_white_list", 7, "string"),
        _r("custom_black_list", 8, "string"),
        _f("use_bf16", 9, "bool", True),
    ],
    "LocalSGDConfig": [
        _f("k_steps", 1, "int32", 1),
        _f("begin_step", 2, "int32", 1),
    ],
    "GradientMergeConfig": [
        _f("k_steps", 1, "int32", 1),
        _f("avg", 2, "bool", True),
    ],
    "DGCConfig": [
        _f("rampup_begin_step", 1, "int32", 0),
        _f("rampup_step", 2, "int32", 1),
        _r("sparsity", 3, "float"),
    ],
    "LarsConfig": [
        _f("lars_coeff", 1, "float", 0.001),
        _f("lars_weight_decay", 2, "float", 0.0005),
        _f("epsilon", 3, "float", 0.0),
        _r("exclude_from_weight_decay", 4, "string"),
    ],
    "LambConfig": [
        _f("lamb_weight_decay", 1, "float", 0.01),
        _r("exclude_from_weight_decay", 2, "string"),
    ],
    "PipelineConfig": [
        _f("micro_batch", 1, "int32", 1),
        _f("accumulate_steps", 2, "int32", 1),
    ],
    "ShardingConfig": [
        _f("fuse_broadcast_MB", 1, "float", 32.0),
        _f("sharding_degree", 2, "int32", 1),
    ],
    "AsyncConfig": [
        _f("k_steps", 1, "int32", -1),
        _f("max_merge_var_num", 2, "int32", 1),
        _f("send_queue_size", 3, "int32", 16),
        _f("independent_recv_thread", 4, "bool", False),
        _f("thread_pool_size", 5, "int32", 1),
        _f("send_wait_times", 6, "int32", 1),
        _f("runtime_split_send_recv", 7, "bool", False),
    ],
    "TensorParallelConfig": [
        _f("tensor_parallel_degree", 1, "int32", 1),
        _f("tensor_parallel_seed", 2, "int32", 0),
    ],
    "DistributedStrategy": [
        _f("amp", 113, "bool", False),
        _f("recompute", 114, "bool", False),
        _f("localsgd", 115, "bool", False),
        _f("dgc", 116, "bool", False),
        _f("gradient_merge", 117, "bool", False),
        _f("lars", 118, "bool", False),
        _f("lamb", 119, "bool", False),
        _f("pipeline", 120, "bool", False),
        _f("elastic", 121, "bool", False),
        _f("auto", 122, "bool", False),
        _f("a_sync", 123, "bool", False),
        _f("nccl_comm_num", 125, "int32", 1),
        _f("use_hierarchical_allreduce", 126, "bool", False),
        _f("hierarchical_allreduce_inter_nranks", 127, "int32", 1),
        _f("sync_batch_norm", 128, "bool", False),
        _f("fuse_all_reduce_ops", 129, "bool", True),
        _f("fuse_grad_size_in_MB", 130, "int32", 32),
        _f("cudnn_exhaustive_search", 131, "bool", False),
        _f("sync_nccl_allreduce", 133, "bool", True),
        _f("fp16_allreduce", 136, "bool", False),
        _f("sharding", 137, "bool", False),
        _f("tensor_parallel", 140, "bool", False),
        _f("sequence_parallel", 141, "bool", False),
        _f("recompute_configs", 201, "RecomputeConfig"),
        _f("amp_configs", 202, "AMPConfig"),
        _f("localsgd_configs", 203, "LocalSGDConfig"),
        _f("gradient_merge_configs", 204, "GradientMergeConfig"),
        _f("dgc_configs", 205, "DGCConfig"),
        _f("lars_configs", 206, "LarsConfig"),
        _f("lamb_configs", 207, "LambConfig"),
        _f("pipeline_configs", 208, "PipelineConfig"),
        _f("sharding_configs", 209, "ShardingConfig"),
        _f("a_sync_configs", 210, "AsyncConfig"),
        _f("tensor_parallel_configs", 211, "TensorParallelConfig"),
    ],
}

_INT32 = (-(1 << 31), (1 << 31) - 1)


def _float32(v) -> float:
    """``v`` rounded to float32, as a proto ``float`` field holds it."""
    return struct.unpack("<f", struct.pack("<f", float(v)))[0]


def _check(msg_name: str, field: Field, v):
    """``v`` as the field's kind holds it; TypeError/ValueError as
    protobuf raises them for a value of the wrong type."""
    kind = field.kind
    if kind == "bool":
        if not isinstance(v, (bool, int)):
            raise TypeError(f"{msg_name}.{field.name}: bool expected, "
                            f"got {type(v).__name__}")
        return bool(v)
    if kind == "int32":
        if isinstance(v, float) or not isinstance(v, int):
            raise TypeError(f"{msg_name}.{field.name}: int32 expected, "
                            f"got {v!r}")
        if not _INT32[0] <= int(v) <= _INT32[1]:
            raise ValueError(f"{msg_name}.{field.name}: {v} is out of "
                             f"int32 range")
        return int(v)
    if kind == "float":
        if isinstance(v, str) or not isinstance(v, (int, float)):
            raise TypeError(f"{msg_name}.{field.name}: float expected, "
                            f"got {v!r}")
        return _float32(v)
    if kind == "string":
        if not isinstance(v, str):
            raise TypeError(f"{msg_name}.{field.name}: str expected, "
                            f"got {type(v).__name__}")
        return v
    raise TypeError(f"{msg_name}.{field.name} is a message; set its "
                    f"fields instead")


class Message:
    """One message's values.  ``get``/``set`` go by field name; a
    repeated field reads as a list (``set`` replaces it)."""

    def __init__(self, name: str):
        if name not in MESSAGES:
            raise KeyError(f"no message {name!r} in distributed_strategy"
                           f".proto")
        self.name = name
        self.fields = {f.name: f for f in MESSAGES[name]}
        self._by_number = {f.number: f for f in MESSAGES[name]}
        self._values: Dict[str, object] = {}

    def field(self, key: str) -> Field:
        f = self.fields.get(key)
        if f is None:
            raise ValueError(
                f"unknown config key {key!r} for {self.name}; valid: "
                f"{sorted(self.fields)}")
        return f

    def get(self, key: str):
        f = self.field(key)
        if f.repeated:
            return list(self._values.get(key, []))
        if f.kind not in _SCALARS:
            if key not in self._values:
                self._values[key] = Message(f.kind)
            return self._values[key]
        if key in self._values:
            return self._values[key]
        return _float32(f.default) if f.kind == "float" else f.default

    def set(self, key: str, value):
        f = self.field(key)
        if f.repeated:
            self._values[key] = [_check(self.name, f, v) for v in value]
        else:
            self._values[key] = _check(self.name, f, value)

    def has(self, key: str) -> bool:
        f = self.field(key)
        v = self._values.get(key)
        if f.repeated:
            return bool(v)
        if f.kind not in _SCALARS:
            return v is not None and v.present()
        return key in self._values

    def present(self) -> bool:
        return any(self.has(k) for k in self.fields)

    def clear(self):
        self._values.clear()

    def listed(self) -> List[Field]:
        """The fields present, in field-number order."""
        return sorted((f for f in self.fields.values() if self.has(f.name)),
                      key=lambda f: f.number)


# ---------------------------------------------------------------------------
# text format
# ---------------------------------------------------------------------------


def _shortest_float(v: float) -> str:
    """protobuf's ``ToShortestFloat``: the fewest significant digits (6
    at least) that read back to the same float32."""
    if math.isnan(v):
        return "nan"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    precision = 6
    rounded = float(f"{v:.{precision}g}")
    while _float32(rounded) != v:
        precision += 1
        rounded = float(f"{v:.{precision}g}")
    return str(rounded)


def _escape(text: str) -> str:
    """protobuf's ``CEscape(text, as_utf8=True)`` (``MessageToString``'s
    default): ASCII control characters as octal escapes, tab, newline,
    carriage return, both quotes and the backslash escaped, the rest of
    the text as it is."""
    special = {9: r"\t", 10: r"\n", 13: r"\r", 34: r"\"", 39: r"\'",
               92: r"\\"}
    out = []
    for c in text:
        b = ord(c)
        if b in special:
            out.append(special[b])
        elif b < 32 or b == 127:
            out.append("\\%03o" % b)
        else:
            out.append(c)
    return "".join(out)


def _scalar_text(kind: str, v) -> str:
    if kind == "bool":
        return "true" if v else "false"
    if kind == "float":
        return _shortest_float(v)
    if kind == "string":
        return '"' + _escape(v) + '"'
    return str(v)


def to_text(msg: Message, indent: int = 0) -> str:
    pad = " " * indent
    lines = []
    for f in msg.listed():
        v = msg._values[f.name]
        if f.kind not in _SCALARS:
            lines.append(f"{pad}{f.name} {{\n")
            lines.append(to_text(v, indent + 2))
            lines.append(f"{pad}}}\n")
        elif f.repeated:
            lines.extend(f"{pad}{f.name}: {_scalar_text(f.kind, x)}\n"
                         for x in v)
        else:
            lines.append(f"{pad}{f.name}: {_scalar_text(f.kind, v)}\n")
    return "".join(lines)


def _tokens(text: str):
    """Identifiers, numbers, quoted strings and the punctuation
    ``: { } < > [ ] , ;``."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
        elif c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c in ":{}<>[],;":
            yield c
            i += 1
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            if j >= n:
                raise ValueError("unterminated string in prototxt")
            yield text[i:j + 1]
            i = j + 1
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in \
                    ":{}<>[],;#\"'":
                j += 1
            yield text[i:j]
            i = j


def _unescape(body: str) -> str:
    out = bytearray()
    i = 0
    simple = {"n": 10, "t": 9, "r": 13, "a": 7, "b": 8, "f": 12, "v": 11,
              "\\": 92, "'": 39, '"': 34, "?": 63}
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.extend(c.encode("utf-8"))
            i += 1
            continue
        nxt = body[i + 1]
        if nxt in simple:
            out.append(simple[nxt])
            i += 2
        elif nxt in "01234567":
            j = i + 1
            while j < min(i + 4, len(body)) and body[j] in "01234567":
                j += 1
            out.append(int(body[i + 1:j], 8))
            i = j
        elif nxt == "x":
            j = i + 2
            while j < min(i + 4, len(body)) and body[j] in \
                    "0123456789abcdefABCDEF":
                j += 1
            out.append(int(body[i + 2:j], 16))
            i = j
        else:
            raise ValueError(f"invalid escape \\{nxt} in prototxt string")
    return out.decode("utf-8")


def _parse_scalar(msg: Message, f: Field, tok: str):
    if f.kind == "string":
        if tok[:1] not in "\"'":
            raise ValueError(f"{msg.name}.{f.name}: a quoted string "
                             f"expected, got {tok!r}")
        return _unescape(tok[1:-1])
    if f.kind == "bool":
        if tok in ("true", "True", "t", "1"):
            return True
        if tok in ("false", "False", "f", "0"):
            return False
        raise ValueError(f"{msg.name}.{f.name}: a bool expected, got "
                         f"{tok!r}")
    if f.kind == "int32":
        return int(tok, 0)
    low = tok.lower()
    if low.lstrip("-") in ("inf", "infinity", "nan"):
        return float(low.replace("infinity", "inf"))
    return float(low[:-1] if low.endswith("f") else low)


def parse_text(text: str, msg: Message) -> Message:
    """Merge the text-format ``text`` into ``msg`` (a repeated field's
    values are appended, as protobuf's ``Parse`` does)."""
    toks = list(_tokens(text))
    pos = _parse_fields(toks, 0, msg, None)
    if pos != len(toks):
        raise ValueError(f"unexpected {toks[pos]!r} in prototxt")
    return msg


def _parse_fields(toks, pos, msg: Message, close):
    while pos < len(toks):
        tok = toks[pos]
        if tok == close:
            return pos
        if tok in (",", ";"):
            pos += 1
            continue
        f = msg.fields.get(tok)
        if f is None:
            raise ValueError(f"message {msg.name} has no field named "
                             f"{tok!r}")
        pos += 1
        if f.kind not in _SCALARS:
            if toks[pos] == ":":
                pos += 1
            opener = toks[pos]
            if opener not in ("{", "<"):
                raise ValueError(f"{msg.name}.{f.name}: '{{' expected")
            end = "}" if opener == "{" else ">"
            sub = msg.get(f.name)
            pos = _parse_fields(toks, pos + 1, sub, end)
            if pos >= len(toks):
                raise ValueError(f"{msg.name}.{f.name}: missing {end!r}")
            pos += 1
            continue
        if toks[pos] != ":":
            raise ValueError(f"{msg.name}.{f.name}: ':' expected")
        pos += 1
        if toks[pos] == "[":
            if not f.repeated:
                raise ValueError(f"{msg.name}.{f.name} is not repeated")
            pos += 1
            vals = []
            while toks[pos] != "]":
                if toks[pos] != ",":
                    vals.append(_parse_scalar(msg, f, toks[pos]))
                pos += 1
            pos += 1
        else:
            vals = [_parse_scalar(msg, f, toks[pos])]
            pos += 1
        if f.repeated:
            msg.set(f.name, msg.get(f.name) + vals)
        else:
            msg.set(f.name, vals[0])
    if close is not None:
        raise ValueError(f"message {msg.name}: missing {close!r}")
    return pos


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def _scalar_bytes(f: Field, v) -> bytes:
    if f.kind in ("bool", "int32"):
        return _key(f.number, _VARINT) + _varint(int(v))
    if f.kind == "float":
        return _key(f.number, _I32) + struct.pack("<f", v)
    return _len(f.number, v.encode("utf-8"))


def to_bytes(msg: Message) -> bytes:
    out = bytearray()
    for f in msg.listed():
        v = msg._values[f.name]
        if f.kind not in _SCALARS:
            out += _len(f.number, to_bytes(v))
        elif f.repeated:
            for x in v:
                out += _scalar_bytes(f, x)
        else:
            out += _scalar_bytes(f, v)
    return bytes(out)


def _wire_values(f: Field, wire: int, val) -> list:
    if f.kind == "string":
        return [bytes(val).decode("utf-8")]
    if f.kind == "float":
        if wire == _I32:
            return [struct.unpack("<f", val)[0]]
        if wire == _LEN:   # packed
            return list(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
    elif wire == _VARINT:
        return [_signed(val)]
    elif wire == _LEN:     # packed varints
        out, pos = [], 0
        while pos < len(val):
            n, pos = _read_varint(val, pos)
            out.append(_signed(n))
        return out
    raise ValueError(f"field {f.name}: wire type {wire} does not fit "
                     f"{f.kind}")


def from_bytes(data: bytes, msg: Message) -> Message:
    """Merge the serialized ``data`` into ``msg``."""
    for number, wire, val in _fields(memoryview(data)):
        f = msg._by_number.get(number)
        if f is None or wire == _I64:
            continue   # unknown fields are skipped, as protobuf does
        if f.kind not in _SCALARS:
            from_bytes(bytes(val), msg.get(f.name))
            continue
        vals = _wire_values(f, wire, val)
        if f.kind == "int32":
            vals = [((v + (1 << 31)) % (1 << 32)) - (1 << 31) for v in vals]
        if f.repeated:
            msg.set(f.name, msg.get(f.name) + vals)
        else:
            msg.set(f.name, vals[-1])
    return msg
