"""Top-level paddle.save / paddle.load.

Counterpart of ``paddle_tpu/serialization.py`` (reference
python/paddle/framework/io.py save:177/load:361), with its file format:
``PTPUPKL1`` then a pickle of the object with every tensor as a numpy
array (state dicts, tensors, nested lists, tuples and namedtuples), or
``PTPUPROG`` then a ``Program``'s serialized desc.  Each package's
``load`` reads the other's files.

bfloat16 and float8 tensors have no numpy type without ``ml_dtypes``,
which the card's machine lacks: ``save`` writes one as the dict
``{"__dtype__": <the JAX package's dtype string>, "__bits__": <its raw
bits as int16 / uint8>}`` and the port's ``load`` gives the tensor back.
The JAX package's ``load`` returns that dict as it is, and a JAX-written
``ml_dtypes`` array needs ``ml_dtypes`` to unpickle.

``load`` places every array on ``device`` as a tensor (the card unless
told otherwise, ``device="cpu"`` for host tensors).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .framework.place import DeviceLike, default_device
from .framework.scope import to_tensor

_MAGIC = b"PTPUPKL1"
_PROG_MAGIC = b"PTPUPROG"
# torch dtype -> (the JAX package's dtype string, the bits' torch dtype)
_BITS = {torch.bfloat16: ("bfloat16", torch.int16),
         torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
         torch.float8_e5m2: ("float8_e5m2", torch.uint8)}
_FROM_BITS = {name: t for t, (name, _) in _BITS.items()}


def _to_host(obj):
    """Tensors (and the dygraph ``Tensor``) -> numpy, recursively."""
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    t = getattr(obj, "_value", None)   # the dygraph Tensor wraps one
    if isinstance(t, torch.Tensor):
        obj = t
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype in _BITS:
            name, bits = _BITS[t.dtype]
            return {"__dtype__": name, "__bits__": t.view(bits).numpy()}
        return t.numpy()
    return obj


def _to_device(obj, dev):
    if isinstance(obj, dict):
        if set(obj) == {"__dtype__", "__bits__"} \
                and obj["__dtype__"] in _FROM_BITS:
            bits = torch.from_numpy(np.ascontiguousarray(obj["__bits__"]))
            return bits.view(_FROM_BITS[obj["__dtype__"]]).to(dev)
        return {k: _to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_device(v, dev) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, dev) for v in obj)
    if isinstance(obj, np.ndarray):
        return to_tensor(obj, dev)
    return obj


def save(obj, path: str, protocol: int = 4):
    from .framework.program import Program

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    if isinstance(obj, Program):
        with open(path, "wb") as f:
            f.write(_PROG_MAGIC)
            f.write(obj.serialize_to_string())
        return
    with open(path, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(_to_host(obj), f, protocol=protocol)


def load(path: str, device: DeviceLike = None):
    """What ``save`` wrote: a ``Program``, or the object with its arrays
    as tensors on ``device`` (the card unless told otherwise)."""
    from .framework.program import Program

    if not os.path.exists(path):
        raise FileNotFoundError(f"paddle.load: no such file {path!r}")
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic == _PROG_MAGIC:
            return Program.parse_from_string(f.read())
        if magic != _MAGIC:
            raise ValueError(
                f"{path!r} was not written by paddle_tpu.save "
                f"(bad magic {magic!r})")
        obj = pickle.load(f)
    return _to_device(obj, default_device(device))
