"""Datasets that the loader tests (``test_torch_io.py``) send to spawned
worker processes.  They live in a module of their own, importing numpy
and os only, so that each worker unpickles them without importing the
test module (and with it both packages and JAX)."""
import os

import numpy as np


class Squares:
    def __len__(self):
        return 20

    def __getitem__(self, i):
        return np.array([i * i], "f4"), np.array([i], "i8")


class WhereAmI:
    """Each sample: the process id, whether that process initialized
    CUDA, whether CUDA_VISIBLE_DEVICES is set to the empty string there,
    and the worker id (-1 outside a worker)."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        import torch

        from paddle_tpu_torch.io import get_worker_info

        info = get_worker_info()
        return np.array([os.getpid(), int(torch.cuda.is_initialized()),
                         int(os.environ.get("CUDA_VISIBLE_DEVICES") == ""),
                         -1 if info is None else info.id], "i8")


class Boom:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("synthetic decode failure at 5")
        return np.array([i], "f4")
