"""`paddle.utils` equivalent (reference python/paddle/utils/): small
developer helpers.

Counterpart of ``paddle_tpu/utils/__init__.py``: ``unique_name``,
``deprecated`` (a warning made visible once per call site),
``try_import``, ``run_check`` (a small static program through the port's
``Executor`` on the CUDA card; it raises where torch sees no card,
with no CPU fallback) and ``download``, which raises: the port runs
where there is no network, so a dataset points at local files.
"""
from __future__ import annotations

import functools
import importlib
import sys
import warnings

from ..framework import unique_name  # noqa: F401


def deprecated(update_to: str = "", since: str = "", reason: str = ""):
    """Reference utils/deprecated.py: warn once per call site, and make
    the warning visible (``DeprecationWarning`` is filtered by default
    outside ``__main__``; the reference forces it for the same reason)."""

    def deco(fn):
        warned_sites = set()

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            frame = sys._getframe(1)
            site = (frame.f_code.co_filename, frame.f_lineno)
            if site not in warned_sites:
                warned_sites.add(site)
                msg = f"API {fn.__module__}.{fn.__name__} is deprecated"
                if since:
                    msg += f" since {since}"
                if update_to:
                    msg += f"; use {update_to} instead"
                if reason:
                    msg += f" ({reason})"
                with warnings.catch_warnings():
                    warnings.simplefilter("always", DeprecationWarning)
                    warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return deco


def try_import(module_name: str, err_msg: str = None):
    """Reference utils/lazy_import.py ``try_import``."""
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"required optional module {module_name!r} is not "
                       f"installed") from e


def run_check():
    """Reference ``paddle.utils.run_check``: run a small program (``fc``
    of 4 features to 2) through the ``Executor`` on CUDA card 0 and check
    its output's shape.  Raises where torch sees no card."""
    import numpy as np
    import torch

    from .. import layers
    from ..framework.executor import Executor
    from ..framework.place import CUDAPlace
    from ..framework.program import Program, program_guard
    from ..framework.scope import Scope

    if not torch.cuda.is_available():
        raise RuntimeError(
            "run_check runs its program on a CUDA card and torch sees "
            "none: the port has no CPU fallback for it")
    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("x", [4])
        y = layers.fc(x, 2)
    exe = Executor(CUDAPlace(0))
    scope = Scope()
    exe.run(startup, scope=scope)
    out = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                  fetch_list=[y], scope=scope)
    shape = np.asarray(out[0]).shape
    if shape != (2, 2):
        raise RuntimeError(
            f"run_check produced shape {shape}, expected (2, 2): the "
            f"install is broken")
    print(f"paddle_tpu_torch is installed successfully on "
          f"{torch.cuda.get_device_name(0)}!")


def download(url, module_name=None, save_name=None, **kw):
    raise RuntimeError(
        "paddle_tpu_torch.utils.download is unavailable: the port runs "
        "where there is no network; place the file locally and point the "
        "dataset at it")
