"""Program / Block / Variable / Operator — the graph IR builders.

Counterpart of ``paddle_tpu/framework/program.py``, copied with two
changes so that a host without ``google.protobuf`` (the CUDA machines
the port runs on need not have it) builds, clones and runs programs:

- ``ir_pb2`` (a byte-identical copy of the JAX package's generated
  module, so both packages share one message pool) is imported only by
  ``to_proto``/``from_proto``; ``serialize_to_string``/
  ``parse_from_string`` speak the same wire format through the port's
  own codec (``ir_wire.py``), which needs no protobuf;
- ``Program.clone()`` copies the Python objects instead of round-tripping
  through the proto, with the same result: attributes normalized as the
  proto would (tuples to lists, numpy scalars to Python ones, blocks to
  their index), ``Parameter`` objects become plain ``Variable`` objects
  with ``is_parameter`` set, build-site stacks keep their last 3 frames.

Role parity: reference python/paddle/fluid/framework.py (Program/Block/
Variable/Operator/Parameter, program_guard, default_main_program) and the
C++ desc wrappers (program_desc.h, block_desc.h, op_desc.h, var_desc.h).
Variables carry no storage: runtime values live in a Scope of tensors
keyed by name, and the Executor lowers a block op by op (executor.py).
"""
from __future__ import annotations

import contextlib
import hashlib
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import dtypes, unique_name

VK_DENSE = 0  # ir.proto VarKind.VK_DENSE


def _pb():
    """The generated protobuf module, imported at first serialization."""
    from . import ir_pb2

    return ir_pb2

# ---------------------------------------------------------------------------
# Attribute helpers
# ---------------------------------------------------------------------------


def _attr_normalize(value):
    """``(field, value)``: the ``Attr`` oneof field that ir.proto stores
    ``value`` in, and the value as it reads back from there."""
    if isinstance(value, bool):
        return "b", value
    if isinstance(value, (int, np.integer)):
        return "i", int(value)
    if isinstance(value, (float, np.floating)):
        return "f", float(value)
    if isinstance(value, str):
        return "s", value
    if isinstance(value, Block):
        return "block", value.idx
    if isinstance(value, (list, tuple, np.ndarray)):
        vals = list(value)
        if len(vals) and isinstance(vals[0], Block):
            return "blocks", [b.idx for b in vals]
        if len(vals) and isinstance(vals[0], bool):
            return "bools", [bool(v) for v in vals]
        if all(isinstance(v, (int, np.integer)) for v in vals):
            return "ints", [int(v) for v in vals]
        if all(isinstance(v, (int, float, np.integer, np.floating))
               for v in vals):
            return "floats", [float(v) for v in vals]
        if all(isinstance(v, str) for v in vals):
            return "strings", vals
        raise TypeError(f"unsupported list attribute {value!r}")
    raise TypeError(f"unsupported attribute type {type(value)}: {value!r}")


def _attr_to_proto(value) -> "ir_pb2.Attr":
    kind, v = _attr_normalize(value)
    a = _pb().Attr()
    if isinstance(v, list):
        getattr(a, kind).v.extend(v)
    else:
        setattr(a, kind, v)
    return a


def _attr_from_proto(a: "ir_pb2.Attr"):
    kind = a.WhichOneof("value")
    if kind is None:
        return None
    v = getattr(a, kind)
    if kind in ("ints", "floats", "strings", "bools", "blocks"):
        return list(v.v)
    return v


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------


class Variable:
    """A named slot in a Block.  Holds metadata only (shape may contain -1)."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Sequence[int] | None = None,
        dtype="float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        kind: int = VK_DENSE,
        is_parameter: bool = False,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else ()
        self.dtype = dtypes.to_enum(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.kind = kind
        self.is_parameter = is_parameter
        # populated by initializers / optimizer plumbing
        self.initializer = None
        self.regularizer = None
        self.optimize_attr = {"learning_rate": 1.0}
        self.trainable = not stop_gradient

    # -- api parity -------------------------------------------------------
    @property
    def dtype_str(self) -> str:
        return dtypes.to_str(self.dtype)

    @property
    def lod_level(self) -> int:
        return 0  # ragged tensors are pad+mask in this framework

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= max(s, 0)
        return n

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={list(self.shape)}, "
            f"dtype={self.dtype_str}, persistable={self.persistable})"
        )

    # -- serialization ----------------------------------------------------
    def to_proto(self) -> "ir_pb2.VarDef":
        p = _pb().VarDef(
            name=self.name,
            kind=self.kind,
            dtype=self.dtype,
            persistable=self.persistable,
            stop_gradient=self.stop_gradient,
            is_parameter=self.is_parameter,
        )
        p.shape.extend(self.shape)
        return p

    @staticmethod
    def from_proto(block: "Block", p: "ir_pb2.VarDef") -> "Variable":
        return Variable(
            block,
            p.name,
            shape=list(p.shape),
            dtype=p.dtype if p.dtype != dtypes.DT_UNDEFINED else "float32",
            persistable=p.persistable,
            stop_gradient=p.stop_gradient,
            kind=p.kind,
            is_parameter=p.is_parameter,
        )


class Parameter(Variable):
    """A trainable persistable variable (reference framework.py Parameter)."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True, **kw):
        super().__init__(
            block,
            name,
            shape=shape,
            dtype=dtype,
            persistable=True,
            stop_gradient=not trainable,
            is_parameter=True,
        )
        self.trainable = trainable
        for k, v in kw.items():
            setattr(self, k, v)


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


# device_guard annotation stack (reference fluid.device_guard,
# framework.py device_guard — ops created inside get attr op_device; the
# pipeline optimizer maps "stage:N" annotations to pipeline stages)
_device_guard_stack: List[str] = []


def device_guard(device: str):
    import contextlib

    @contextlib.contextmanager
    def guard():
        _device_guard_stack.append(device)
        try:
            yield
        finally:
            _device_guard_stack.pop()

    return guard()


class Operator:
    """One op in a block: type + slot->names inputs/outputs + attrs."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, object]] = None,
        outputs: Optional[Dict[str, object]] = None,
        attrs: Optional[Dict[str, object]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = _normalize_slots(inputs)
        self.outputs: Dict[str, List[str]] = _normalize_slots(outputs)
        self.attrs: Dict[str, object] = dict(attrs or {})
        # Blocks in attrs are stored by index for serialization friendliness.
        for k, v in list(self.attrs.items()):
            if isinstance(v, Block):
                self.attrs[k] = v.idx
        if _device_guard_stack and "op_device" not in self.attrs:
            self.attrs["op_device"] = _device_guard_stack[-1]
        self.callstack: List[str] = _capture_callstack()

    # -- access -----------------------------------------------------------
    def input(self, slot: str) -> List[str]:
        return list(self.inputs.get(slot, []))

    def output(self, slot: str) -> List[str]:
        return list(self.outputs.get(slot, []))

    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name: str) -> bool:
        return name in self.attrs

    def _rename_input(self, old: str, new: str):
        for ns in self.inputs.values():
            for i, n in enumerate(ns):
                if n == old:
                    ns[i] = new

    def _rename_output(self, old: str, new: str):
        for ns in self.outputs.values():
            for i, n in enumerate(ns):
                if n == old:
                    ns[i] = new

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return f"Operator({self.type}, in={ins}, out={outs}, attrs={self.attrs})"

    # -- serialization ----------------------------------------------------
    def to_proto(self) -> "ir_pb2.OpDef":
        pb = _pb()
        p = pb.OpDef(type=self.type)
        for slot, names in self.inputs.items():
            p.inputs.append(pb.Slot(name=slot, args=names))
        for slot, names in self.outputs.items():
            p.outputs.append(pb.Slot(name=slot, args=names))
        for k, v in self.attrs.items():
            p.attrs[k].CopyFrom(_attr_to_proto(v))
        p.callstack.extend(self.callstack[-3:])
        return p

    @staticmethod
    def from_proto(block: "Block", p: "ir_pb2.OpDef") -> "Operator":
        op = Operator.__new__(Operator)
        op.block = block
        op.type = p.type
        op.inputs = {s.name: list(s.args) for s in p.inputs}
        op.outputs = {s.name: list(s.args) for s in p.outputs}
        op.attrs = {k: _attr_from_proto(a) for k, a in p.attrs.items()}
        op.callstack = list(p.callstack)
        return op


def _normalize_slots(slots) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for slot, val in (slots or {}).items():
        if val is None:
            continue
        if isinstance(val, (Variable, str)):
            val = [val]
        names = [v.name if isinstance(v, Variable) else str(v) for v in val]
        out[slot] = names
    return out


def _capture_callstack() -> List[str]:
    # Keep user frames only; error messages carrying build-site stacks are a
    # product feature of the reference (framework/op_call_stack.h).
    stack = traceback.extract_stack()[:-3]
    frames = [
        f"{f.filename}:{f.lineno} {f.name}"
        for f in stack
        if "/paddle_tpu_torch/" not in f.filename
    ]
    return frames[-5:]


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    # -- vars -------------------------------------------------------------
    def create_var(self, name=None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("tmp_var")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name, shape, dtype="float32", **kw) -> Parameter:
        p = Parameter(self, name, shape, dtype=dtype, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (
                self.program.blocks[blk.parent_idx] if blk.parent_idx >= 0 else None
            )
        return None

    @property
    def parent_block(self) -> Optional["Block"]:
        return self.program.blocks[self.parent_idx] if self.parent_idx >= 0 else None

    # -- ops --------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump()
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump()
        return op

    def _remove_op(self, index: int):
        del self.ops[index]
        self.program._bump()

    # -- serialization ----------------------------------------------------
    def to_proto(self) -> "ir_pb2.BlockDef":
        p = _pb().BlockDef(idx=self.idx, parent_idx=self.parent_idx)
        for v in self.vars.values():
            p.vars.append(v.to_proto())
        for op in self.ops:
            p.ops.append(op.to_proto())
        return p

    @staticmethod
    def from_proto(program: "Program", p: "ir_pb2.BlockDef") -> "Block":
        b = Block(program, p.idx, p.parent_idx)
        for vp in p.vars:
            v = Variable.from_proto(b, vp)
            b.vars[v.name] = v
        for op_p in p.ops:
            b.ops.append(Operator.from_proto(b, op_p))
        return b


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


class Program:
    """An ordered forest of Blocks; the unit of compilation.

    The Executor caches its state analysis by program fingerprint;
    ``_bump`` invalidates the fingerprint on any mutation so a cached
    analysis is never stale.
    """

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._fingerprint_cache: Optional[str] = None
        # set of var names an AMP pass decided to keep fp32 (populated later)
        self._amp_fp32_vars: set = set()

    # -- structure --------------------------------------------------------
    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump()
        return b

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump(self):
        self._version += 1
        self._fingerprint_cache = None

    # -- queries ----------------------------------------------------------
    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.list_vars() if isinstance(v, Parameter) or v.is_parameter]

    # -- serialization ----------------------------------------------------
    def to_proto(self) -> "ir_pb2.ProgramDef":
        p = _pb().ProgramDef(version=1, random_seed=self.random_seed)
        for b in self.blocks:
            p.blocks.append(b.to_proto())
        return p

    def serialize_to_string(self) -> bytes:
        from .ir_wire import encode_program

        return encode_program(self)

    @staticmethod
    def parse_from_string(data: bytes) -> "Program":
        from .ir_wire import decode_program

        prog, feeds, fetches = decode_program(data)
        if feeds or fetches:
            prog._feed_names, prog._fetch_names = feeds, fetches
        return prog

    @staticmethod
    def from_proto(p: "ir_pb2.ProgramDef") -> "Program":
        prog = Program()
        prog.blocks = [Block.from_proto(prog, bp) for bp in p.blocks]
        prog.random_seed = p.random_seed
        if p.feed_names or p.fetch_names:   # a saved inference model
            prog._feed_names = list(p.feed_names)
            prog._fetch_names = list(p.fetch_names)
        prog._bump()
        return prog

    def fingerprint(self) -> str:
        if self._fingerprint_cache is None:
            h = hashlib.sha1()
            for b in self.blocks:
                for op in b.ops:
                    h.update(op.type.encode())
                    for slot in sorted(op.inputs):
                        h.update(f"{slot}:{','.join(op.inputs[slot])};".encode())
                    for slot in sorted(op.outputs):
                        h.update(f">{slot}:{','.join(op.outputs[slot])};".encode())
                    for k in sorted(op.attrs):
                        h.update(f"@{k}={op.attrs[k]!r}".encode())
                for name in sorted(b.vars):
                    v = b.vars[name]
                    h.update(
                        f"v{name}:{v.shape}:{v.dtype}:{v.persistable}".encode()
                    )
            h.update(str(self.random_seed).encode())
            self._fingerprint_cache = h.hexdigest()
        return self._fingerprint_cache

    def clone(self, for_test: bool = False) -> "Program":
        prog = self._copy()
        if for_test:
            for b in prog.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
                    if op.type in ("dropout",):
                        op.attrs["is_test"] = True
                    if op.type in ("batch_norm", "sync_batch_norm"):
                        op.attrs["is_test"] = True
                        op.attrs["use_global_stats"] = True
        return prog

    def _copy(self) -> "Program":
        """What ``from_proto(to_proto())`` gives, without protobuf."""
        prog = Program()
        prog.blocks = []
        for b in self.blocks:
            nb = Block(prog, b.idx, b.parent_idx)
            for v in b.vars.values():
                nb.vars[v.name] = Variable(
                    nb, v.name, shape=list(v.shape),
                    dtype=v.dtype or "float32", persistable=v.persistable,
                    stop_gradient=v.stop_gradient, kind=v.kind,
                    is_parameter=v.is_parameter)
            for op in b.ops:
                nop = Operator.__new__(Operator)
                nop.block = nb
                nop.type = op.type
                nop.inputs = {k: list(ns) for k, ns in op.inputs.items()}
                nop.outputs = {k: list(ns) for k, ns in op.outputs.items()}
                nop.attrs = {k: _attr_normalize(a)[1]
                             for k, a in op.attrs.items()}
                nop.callstack = list(op.callstack[-3:])
                nb.ops.append(nop)
            prog.blocks.append(nb)
        prog.random_seed = self.random_seed
        prog._bump()
        return prog

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={n_ops}, version={self._version})"


# ---------------------------------------------------------------------------
# Default programs & guards (reference framework.py program_guard etc.)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, program
    return old


_guard_depth = 0


def in_program_guard() -> bool:
    """True while user code is inside a program_guard block — used by the
    2.0 dual-mode dispatch to route input-less ops (creation/random) into
    the graph instead of executing them eagerly."""
    return _guard_depth > 0


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    global _guard_depth
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    _guard_depth += 1
    try:
        yield
    finally:
        _guard_depth -= 1
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX
