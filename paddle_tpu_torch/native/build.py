"""On-demand build of the port's CUDA kernels.

Counterpart of ``paddle_tpu/native/build.py`` (one g++ call for the
data-feed extension).  Each ``csrc/<name>.cu`` compiles with ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface,
which ``ops/`` loads with ``ctypes``: no PyTorch headers, so a build
takes seconds instead of minutes.  The library lands in
``paddle_tpu_torch/_build/`` under a name that carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source rebuilds and a checkout with nothing built builds everything at
first use.

``build_all`` starts one ``nvcc`` per source, all at once, and waits
for them together; ``load`` builds (if needed) and opens one library.
There is no fallback: a host without ``nvcc`` raises, and only CPU
tensors take the plain PyTorch versions (see ``ops/paged_attention``,
``ops/flash_attention_bias``, ``ops/flash_attention`` and
``ops/quant_ops``).

``build_host`` / ``load_host`` do the same for a host library,
``csrc/<name>.cc`` compiled by the host's ``g++`` (the MultiSlot
parser, ``csrc/data_feed.cc``, the JAX package's one g++ call); its
caller keeps a Python fallback for a host without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
OUT_DIR = os.path.join(_PKG, "_build")
SOURCES = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "dequant_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
BUILD_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked at $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from "
            "paddle_tpu_torch/csrc at first use")
    return found


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    """Where ``name``'s library lives: keyed by the bytes of its source,
    of the headers beside it and the compiler flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f)
                                       for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(OUT_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Build every library in ``names`` that is not built yet, one
    ``nvcc`` process per source started together; returns name -> path.
    The compiler's report (``-Xptxas=-v``: registers, shared memory,
    spills per kernel) is kept beside each library as ``<lib>.log``."""
    os.makedirs(OUT_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    try:
        for n in todo:
            # per-process temp name: concurrent builds publish atomically
            tmp = f"{paths[n]}.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(n)]
            procs[n] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (cmd, tmp, proc) in procs.items():
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            with open(paths[n] + ".log", "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
                continue
            os.replace(tmp, paths[n])
    finally:
        for _cmd, _tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and open ``name``'s library, once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build_all([name])[name])
        return lib


HOST_SOURCES = ("data_feed",)
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_HOST_LIBS: Dict[str, ctypes.CDLL] = {}


def host_library_path(name: str) -> str:
    """Where host library ``name`` lives: keyed by its source's bytes and
    the compiler flags."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, name + ".cc"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(HOST_FLAGS).encode())
    return os.path.join(OUT_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.cc`` with the host's C++ compiler (``$CXX``,
    else ``g++``, else ``c++``) unless it is built; returns the path."""
    path = host_library_path(name)
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (looked at $CXX, g++ and "
                           "c++ on PATH)")
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [cxx, *HOST_FLAGS, os.path.join(CSRC_DIR, name + ".cc"), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"host build failed: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)   # atomic publish for concurrent builders
    return path


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and open host library ``name``, once per
    process."""
    with _LOCK:
        lib = _HOST_LIBS.get(name)
        if lib is None:
            lib = _HOST_LIBS[name] = ctypes.CDLL(build_host(name))
        return lib
