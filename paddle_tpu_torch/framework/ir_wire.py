"""The protobuf wire format of ``proto/ir.proto``, without protobuf.

A saved inference model is a ``__model__`` file holding one serialized
``ProgramDef``.  The hosts the port runs on need not have
``google.protobuf``, so the port reads and writes those bytes itself:
``encode_program`` and ``decode_program`` speak proto3's wire format for
the six messages of the IR (``ProgramDef``, ``BlockDef``, ``VarDef``,
``OpDef``, ``Slot``, ``Attr`` and its ``Ints``/``Floats``/``Strings``/
``Bools`` lists) and nothing else.  The bytes are the format that
``ir_pb2`` (and so the JAX package) writes and parses, so a model saved
by either package loads in the other.

The format, as far as these messages use it: every field is a key
(``field_number << 3 | wire_type``, a varint) and a value; integers,
enums and bools are varints (a negative int32 or int64 as its 64-bit
two's complement, ten bytes), doubles eight little-endian bytes (wire
type 1), strings and nested messages a varint length and the bytes (wire
type 2).  Proto3 leaves out a singular scalar equal to its default
(0, "", false), except inside a ``oneof``, and writes repeated numbers
packed (one length-delimited run); the decoder also takes them unpacked.
A ``map<string, Attr>`` is a repeated message of (key = 1, value = 2).
Unknown fields are skipped, as protobuf does.

``Program.serialize_to_string``/``parse_from_string`` always go through
this module; ``ir_pb2`` serves ``to_proto``/``from_proto`` and the tests
that hold the two against each other.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_U64 = 1 << 64

# Attr's oneof: the value kind (program._attr_normalize) -> field number
_ATTR_FIELDS = {"i": 1, "f": 2, "s": 3, "b": 4, "ints": 5, "floats": 6,
                "strings": 7, "bools": 8, "block": 9, "blocks": 10}
_ATTR_KINDS = {v: k for k, v in _ATTR_FIELDS.items()}


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:
        n += _U64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int(field: int, v: int, always: bool = False) -> bytes:
    v = int(v)
    return _key(field, _VARINT) + _varint(v) if v or always else b""


def _double(field: int, v: float, always: bool = False) -> bytes:
    raw = struct.pack("<d", float(v))
    return _key(field, _I64) + raw if always or raw != bytes(8) else b""


def _len(field: int, payload: bytes) -> bytes:
    return _key(field, _LEN) + _varint(len(payload)) + payload


def _str(field: int, v: str, always: bool = False) -> bytes:
    return _len(field, v.encode()) if v or always else b""


def _strs(field: int, vs: Sequence[str]) -> bytes:
    return b"".join(_len(field, v.encode()) for v in vs)


def _packed_ints(field: int, vs: Sequence[int]) -> bytes:
    return _len(field, b"".join(_varint(int(v)) for v in vs)) if vs else b""


def _packed_doubles(field: int, vs: Sequence[float]) -> bytes:
    return _len(field, struct.pack(f"<{len(vs)}d", *vs)) if vs else b""


def _attr(value) -> bytes:
    from .program import _attr_normalize

    kind, v = _attr_normalize(value)
    field = _ATTR_FIELDS[kind]
    if kind in ("i", "block"):
        return _int(field, v, always=True)
    if kind == "b":
        return _int(field, int(v), always=True)
    if kind == "f":
        return _double(field, v, always=True)
    if kind == "s":
        return _str(field, v, always=True)
    if kind in ("ints", "blocks"):
        inner = _packed_ints(1, v)
    elif kind == "bools":
        inner = _packed_ints(1, [int(b) for b in v])
    elif kind == "floats":
        inner = _packed_doubles(1, v)
    else:  # strings
        inner = _strs(1, v)
    return _len(field, inner)


def _var(v) -> bytes:
    return b"".join((
        _str(1, v.name), _int(2, v.kind), _int(3, v.dtype),
        _packed_ints(4, v.shape), _int(5, bool(v.persistable)),
        _int(6, bool(v.stop_gradient)), _int(7, bool(v.is_parameter))))


def _slot(name: str, args: Sequence[str]) -> bytes:
    return _str(1, name) + _strs(2, args)


def _op(op) -> bytes:
    parts = [_str(1, op.type)]
    parts += [_len(2, _slot(k, ns)) for k, ns in op.inputs.items()]
    parts += [_len(3, _slot(k, ns)) for k, ns in op.outputs.items()]
    parts += [_len(4, _str(1, k, always=True) + _len(2, _attr(a)))
              for k, a in op.attrs.items()]
    parts.append(_strs(5, op.callstack[-3:]))
    return b"".join(parts)


def _block(b) -> bytes:
    parts = [_int(1, b.idx), _int(2, b.parent_idx)]
    parts += [_len(3, _var(v)) for v in b.vars.values()]
    parts += [_len(4, _op(op)) for op in b.ops]
    return b"".join(parts)


def encode_program(program, feed_names: Sequence[str] = (),
                   fetch_names: Sequence[str] = ()) -> bytes:
    """``program`` as serialized ``ProgramDef`` bytes (what
    ``program.to_proto()`` with ``feed_names``/``fetch_names`` appended
    serializes to, map entries aside, whose order the format leaves
    open)."""
    parts = [_len(1, _block(b)) for b in program.blocks]
    parts += [_int(2, 1), _int(3, program.random_seed),
              _strs(4, feed_names), _strs(5, fetch_names)]
    return b"".join(parts)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in ProgramDef bytes")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes in ProgramDef "
                             "bytes")


def _signed(n: int) -> int:
    return n - _U64 if n >= 1 << 63 else n


def _fields(buf):
    """(field number, wire type, value) of each field of one message:
    an int for a varint, the raw bytes otherwise."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _I64:
            val, pos = bytes(buf[pos:pos + 8]), pos + 8
        elif wire == _LEN:
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == _I32:
            val, pos = bytes(buf[pos:pos + 4]), pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field}) "
                             f"in ProgramDef bytes")
        if pos > end:
            raise ValueError("truncated field in ProgramDef bytes")
        yield field, wire, val


def _ints(wire: int, val) -> List[int]:
    """A repeated integer field's values, packed or not."""
    if wire == _VARINT:
        return [_signed(val)]
    out, pos = [], 0
    while pos < len(val):
        n, pos = _read_varint(val, pos)
        out.append(_signed(n))
    return out


def _doubles(wire: int, val) -> List[float]:
    if wire == _I64:
        return [struct.unpack("<d", val)[0]]
    return list(struct.unpack(f"<{len(val) // 8}d", bytes(val)))


def _text(val) -> str:
    return bytes(val).decode()


def _decode_attr(buf):
    """The python value ``Operator.from_proto`` gives for one ``Attr``
    (None when no field of the oneof is set)."""
    out = None
    for field, wire, val in _fields(buf):
        kind = _ATTR_KINDS.get(field)
        if kind in ("i", "block"):
            out = _signed(val)
        elif kind == "b":
            out = bool(val)
        elif kind == "f":
            out = struct.unpack("<d", val)[0]
        elif kind == "s":
            out = _text(val)
        elif kind is not None:
            items: list = []
            for f2, w2, v2 in _fields(val):
                if f2 != 1:
                    continue
                if kind == "floats":
                    items += _doubles(w2, v2)
                elif kind == "strings":
                    items.append(_text(v2))
                elif kind == "bools":
                    items += [bool(x) for x in _ints(w2, v2)]
                else:
                    items += _ints(w2, v2)
            out = items
    return out


def _decode_var(block, buf):
    from . import dtypes
    from .program import Variable

    f: Dict[str, object] = dict(name="", kind=0, dtype=0, persistable=False,
                                stop_gradient=False, is_parameter=False)
    shape: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            f["name"] = _text(val)
        elif field == 2:
            f["kind"] = val
        elif field == 3:
            f["dtype"] = val
        elif field == 4:
            shape += _ints(wire, val)
        elif field in (5, 6, 7):
            f[("persistable", "stop_gradient", "is_parameter")[field - 5]] = \
                bool(val)
    return Variable(
        block, f["name"], shape=shape,
        dtype=f["dtype"] if f["dtype"] != dtypes.DT_UNDEFINED else "float32",
        persistable=f["persistable"], stop_gradient=f["stop_gradient"],
        kind=f["kind"], is_parameter=f["is_parameter"])


def _decode_slot(buf) -> Tuple[str, List[str]]:
    name, args = "", []
    for field, _wire, val in _fields(buf):
        if field == 1:
            name = _text(val)
        elif field == 2:
            args.append(_text(val))
    return name, args


def _decode_op(block, buf):
    from .program import Operator

    op = Operator.__new__(Operator)
    op.block = block
    op.type = ""
    op.inputs, op.outputs, op.attrs, op.callstack = {}, {}, {}, []
    for field, _wire, val in _fields(buf):
        if field == 1:
            op.type = _text(val)
        elif field in (2, 3):
            name, args = _decode_slot(val)
            (op.inputs if field == 2 else op.outputs)[name] = args
        elif field == 4:
            key, value = "", None
            for f2, _w2, v2 in _fields(val):
                if f2 == 1:
                    key = _text(v2)
                elif f2 == 2:
                    value = _decode_attr(v2)
            op.attrs[key] = value
        elif field == 5:
            op.callstack.append(_text(val))
    return op


def _decode_block(program, buf):
    from .program import Block

    idx = parent = 0
    var_bufs, op_bufs = [], []
    for field, _wire, val in _fields(buf):
        if field == 1:
            idx = _signed(val)
        elif field == 2:
            parent = _signed(val)
        elif field == 3:
            var_bufs.append(val)
        elif field == 4:
            op_bufs.append(val)
    b = Block(program, idx, parent)
    for vb in var_bufs:
        v = _decode_var(b, vb)
        b.vars[v.name] = v
    b.ops = [_decode_op(b, ob) for ob in op_bufs]
    return b


def decode_program(data: bytes):
    """``(program, feed_names, fetch_names)`` from serialized
    ``ProgramDef`` bytes: the program ``Program.from_proto`` builds from
    the parsed message."""
    from .program import Program

    buf = memoryview(data)
    prog = Program()
    blocks, feeds, fetches = [], [], []
    seed = 0
    for field, _wire, val in _fields(buf):
        if field == 1:
            blocks.append(val)
        elif field == 3:
            seed = _signed(val)
        elif field == 4:
            feeds.append(_text(val))
        elif field == 5:
            fetches.append(_text(val))
    prog.blocks = [_decode_block(prog, b) for b in blocks]
    prog.random_seed = seed
    prog._bump()
    return prog, feeds, fetches
