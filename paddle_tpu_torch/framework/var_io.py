"""Variable serialization: the byte format behind save/load ops.

Role parity: reference framework/save_load_util.cc + the LoDTensor byte
stream written by save_op.cc:85 (version + dims + dtype + data).  The
TPU-native format keeps the same shape — a small versioned header plus raw
bytes — but uses a JSON header instead of the C++ struct layout (bitwise
format compatibility with the reference is a non-goal; API and round-trip
fidelity are the contract).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List

import numpy as np

MAGIC = b"PTPUVAR1"
COMBINE_MAGIC = b"PTPUCMB1"


def _header_bytes(arr: np.ndarray) -> bytes:
    h = json.dumps({"dtype": str(arr.dtype),
                    "shape": list(arr.shape)}).encode()
    return struct.pack("<I", len(h)) + h


def _np_dtype(name: str, var: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        pass
    try:
        import ml_dtypes
    except ImportError:
        raise TypeError(
            f"variable {var!r} is stored as {name}, which numpy reads only "
            f"through the ml_dtypes package, and this host has none") \
            from None
    return np.dtype(getattr(ml_dtypes, name))


def _read_header(f, var: str):
    (hlen,) = struct.unpack("<I", f.read(4))
    h = json.loads(f.read(hlen).decode())
    return _np_dtype(h["dtype"], var), tuple(h["shape"])


def save_var(arr: np.ndarray, path: str) -> None:
    arr = np.ascontiguousarray(arr)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_header_bytes(arr))
        f.write(arr.tobytes())


def load_var(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(
                f"{path!r} is not a paddle_tpu variable file "
                f"(bad magic {magic!r})")
        dtype, shape = _read_header(f, os.path.basename(path))
        data = f.read()
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


def save_combine(arrays: Dict[str, np.ndarray], order: List[str],
                 path: str) -> None:
    """All vars in one file, in the given order (reference
    save_combine_op)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(COMBINE_MAGIC)
        f.write(struct.pack("<I", len(order)))
        for name in order:
            arr = np.ascontiguousarray(arrays[name])
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)) + nb)
            f.write(_header_bytes(arr))
            payload = arr.tobytes()
            f.write(struct.pack("<Q", len(payload)))
            f.write(payload)


def load_combine(path: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        magic = f.read(len(COMBINE_MAGIC))
        if magic != COMBINE_MAGIC:
            raise ValueError(
                f"{path!r} is not a paddle_tpu combined-params file "
                f"(bad magic {magic!r})")
        (count,) = struct.unpack("<I", f.read(4))
        for _ in range(count):
            (nlen,) = struct.unpack("<I", f.read(4))
            name = f.read(nlen).decode()
            dtype, shape = _read_header(f, name)
            (plen,) = struct.unpack("<Q", f.read(8))
            data = f.read(plen)
            out[name] = np.frombuffer(data, dtype=dtype).reshape(shape).copy()
    return out
