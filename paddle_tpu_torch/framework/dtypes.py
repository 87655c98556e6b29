"""Dtype bridging between the IR enum, strings, numpy and torch.

Counterpart of ``paddle_tpu/framework/dtypes.py``.  The enum values are
those of ``proto/ir.proto`` (``DType``), written out here as plain ints
so that building and running a program never imports protobuf; the
serialization contract keeps them stable (append only).  ``to_torch``
replaces the JAX package's ``to_jnp``.  64-bit types stay 64-bit: torch
has no x64 switch, so an ``int64`` feed or ``fill_constant`` keeps its
type where the JAX package (x64 disabled) computes in 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

DT_UNDEFINED = 0

# Public names mirror the reference's string dtype vocabulary so user code
# like ``fluid.data(..., dtype='float32')`` works unchanged.
_STR_TO_ENUM = {
    "float32": 1,
    "float64": 2,
    "float16": 3,
    "bfloat16": 4,
    "int8": 5,
    "int16": 6,
    "int32": 7,
    "int64": 8,
    "uint8": 9,
    "bool": 10,
    "complex64": 11,
    "complex128": 12,
    "uint16": 13,
    "uint32": 14,
    "uint64": 15,
}

_ENUM_TO_STR = {v: k for k, v in _STR_TO_ENUM.items()}

_FLOATING = {"float32", "float64", "float16", "bfloat16"}


def to_enum(dtype) -> int:
    """Normalize a dtype spec (str | np.dtype | torch.dtype | enum) to
    the IR enum."""
    if isinstance(dtype, int):
        if dtype not in _ENUM_TO_STR and dtype != DT_UNDEFINED:
            raise ValueError(f"unknown dtype enum {dtype}")
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR_TO_ENUM:
            raise ValueError(f"unknown dtype string {dtype!r}")
        return _STR_TO_ENUM[dtype]
    if isinstance(dtype, torch.dtype):
        name = str(dtype)[len("torch."):]
    else:  # numpy dtype objects (incl. ml_dtypes.bfloat16)
        name = getattr(dtype, "name", None) or np.dtype(dtype).name
        if name not in _STR_TO_ENUM:
            name = np.dtype(dtype).name
    if name not in _STR_TO_ENUM:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _STR_TO_ENUM[name]


def to_str(dtype) -> str:
    return _ENUM_TO_STR[to_enum(dtype)]


def to_torch(dtype) -> torch.dtype:
    """IR enum/str/numpy/torch dtype -> torch.dtype."""
    return getattr(torch, to_str(dtype))


def to_np(dtype) -> np.dtype:
    """IR enum/str/numpy/torch dtype -> numpy dtype (bfloat16, which
    numpy lacks, as float32)."""
    name = to_str(dtype)
    return np.dtype("float32" if name == "bfloat16" else name)


def is_floating(dtype) -> bool:
    return to_str(dtype) in _FLOATING
