"""Native components of the port: the CUDA kernels' build
(``build.py``) and the host MultiSlot parser.

``parse_multislot`` is the counterpart of ``paddle_tpu/native``'s: the
parse loop is C++ (``csrc/data_feed.cc``, a plain C interface), built
with the host's ``g++`` into ``paddle_tpu_torch/_build/`` at first use and
loaded with ``ctypes``, which releases the GIL while it parses.  On a
host without a compiler the JAX package's pure-Python fallback
(``_parse_multislot_py``, copied) gives the same arrays and the same
errors, slower; each such parse counts ``data_feed_parse_fallback``.
"""
from __future__ import annotations

import ctypes

import numpy as np

# lazy: importing this package must not pay a compiler subprocess
_lib = None
_lib_tried = False
_ERR_CAP = 512


def _get_lib():
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        try:
            from . import build

            lib = build.load_host("data_feed")
        except (RuntimeError, OSError):
            # any build-environment failure (no compiler, unwritable
            # dir, bad CXX) means the fallback, never a caller crash
            lib = None
        if lib is not None:
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.pt_multislot_parse.argtypes = [
                ctypes.c_char_p, i64, ctypes.c_char_p, ctypes.c_char_p, i64,
                ctypes.POINTER(i64)]
            lib.pt_multislot_parse.restype = p
            lib.pt_multislot_count.argtypes = [p, ctypes.c_int]
            lib.pt_multislot_count.restype = i64
            lib.pt_multislot_copy.argtypes = [p, ctypes.c_int, p, p]
            lib.pt_multislot_copy.restype = None
            lib.pt_multislot_free.argtypes = [p]
            lib.pt_multislot_free.restype = None
        _lib = lib
    return _lib


def has_native() -> bool:
    return _get_lib() is not None


def parse_multislot(data: bytes, slot_types: str):
    """Parse MultiSlot text data into per-slot (values, lod) arrays.

    ``slot_types``: one char per slot -- 'f' float32 values, 'u' uint64
    ids.  Returns (n_instances, [(values_ndarray, lod_ndarray), ...]);
    lod holds cumulative offsets (len n_instances+1), reference LoD
    level-0 semantics.
    """
    if isinstance(data, str):
        data = data.encode()
    lib = _get_lib()
    if lib is None:
        from ..monitor import stat_add

        stat_add("data_feed_parse_fallback")
        return _parse_multislot_py(data, slot_types)
    err = ctypes.create_string_buffer(_ERR_CAP)
    n = ctypes.c_int64(0)
    handle = lib.pt_multislot_parse(bytes(data), len(data),
                                    slot_types.encode(), err, _ERR_CAP,
                                    ctypes.byref(n))
    if not handle:
        raise ValueError(err.value.decode())
    try:
        out = []
        for s, t in enumerate(slot_types):
            vals = np.empty(lib.pt_multislot_count(handle, s),
                            np.float32 if t == "f" else np.uint64)
            lod = np.empty(n.value + 1, np.int64)
            lib.pt_multislot_copy(handle, s, vals.ctypes.data,
                                  lod.ctypes.data)
            out.append((vals, lod))
    finally:
        lib.pt_multislot_free(handle)
    return n.value, out


def _parse_multislot_py(data: bytes, slot_types: str):
    """Pure-python fallback -- same outputs AND same errors as the
    native parser (malformed input must not silently flip behavior
    between hosts with and without a compiler)."""
    vals = [[] for _ in slot_types]
    lods = [[0] for _ in slot_types]
    n = 0
    for line in data.split(b"\n"):
        toks = line.split()
        if not toks:
            continue
        i = 0
        for s, t in enumerate(slot_types):
            try:
                # match strtoll + boundary-check semantics: plain digits
                # only (no python underscore literals)
                if b"_" in toks[i]:
                    raise ValueError
                cnt = int(toks[i])
            except (IndexError, ValueError):
                raise ValueError(f"bad slot count at line {n}")
            if cnt < 0:
                raise ValueError(f"bad slot count at line {n}")
            i += 1
            if i + cnt > len(toks):
                raise ValueError(
                    f"bad {'float' if t == 'f' else 'id'} value at line {n}")
            try:
                for x in toks[i:i + cnt]:
                    if b"_" in x:  # python literals allow _, strtox doesn't
                        raise ValueError
                    if t == "f":
                        vals[s].append(float(x))
                    else:
                        # match strtoull semantics: plain digits only,
                        # negatives wrap into uint64 like the C path;
                        # out-of-range magnitudes are rejected in BOTH
                        # paths (the C side checks ERANGE)
                        if not x.lstrip(b"-+").isdigit():
                            raise ValueError
                        iv = int(x)
                        if not (-(2 ** 64) < iv < 2 ** 64):
                            raise ValueError
                        vals[s].append(iv & 0xFFFFFFFFFFFFFFFF)
            except ValueError:
                raise ValueError(
                    f"bad {'float' if t == 'f' else 'id'} value at line {n}")
            i += cnt
            lods[s].append(len(vals[s]))
        if i != len(toks):
            raise ValueError(f"trailing tokens at line {n}")
        n += 1
    out = []
    for s, t in enumerate(slot_types):
        dt = np.float32 if t == "f" else np.uint64
        out.append((np.asarray(vals[s], dtype=dt),
                    np.asarray(lods[s], dtype=np.int64)))
    return n, out
