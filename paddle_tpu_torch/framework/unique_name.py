"""Unique name generation for program variables.

Copy of ``paddle_tpu/framework/unique_name.py`` (the JAX package's
module imports no JAX); the program it builds is the same, op for op.

Role parity: reference python/paddle/fluid/unique_name.py (UniqueNameGenerator,
generate, guard, switch).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        i = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{i}"


_generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return _generator(key)


def switch(new_generator: UniqueNameGenerator | None = None) -> UniqueNameGenerator:
    global _generator
    old = _generator
    _generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator: UniqueNameGenerator | None = None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
