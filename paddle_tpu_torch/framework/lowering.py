"""Op lowering registry: IR op -> torch calls, run op by op.

Counterpart of ``paddle_tpu/framework/lowering.py``.  There each rule
runs once at trace time and emits jax ops into one XLA computation; here
the executor calls each op's rule eagerly, every step, over a dict of
tensors.  A rule has the same signature, ``rule(ctx, op) -> None``, and
communicates through the environment (``ctx.get``/``ctx.set``).

Randomness: the JAX package threads a jax PRNG key through the program
(``next_key``); here ``next_generator`` hands out the executor's
``torch.Generator`` on the program's device, so random ops draw from one
stream in program order.  The two streams differ, so tests compare
random ops by their statistics.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

LOWERINGS: Dict[str, Callable] = {}

# ops the executor itself handles (data movement endpoints)
PSEUDO_OPS = {"feed", "fetch"}


def register_lower(*op_types: str):
    def deco(fn):
        for t in op_types:
            if t in LOWERINGS:
                raise RuntimeError(f"duplicate lowering for op {t!r}")
            LOWERINGS[t] = fn
        return fn

    return deco


# installed by ops/grad_generic.py: fallback for unregistered *_grad ops
GENERIC_GRAD_LOWERING: Optional[Callable] = None


def get_lowering(op_type: str) -> Callable:
    try:
        return LOWERINGS[op_type]
    except KeyError:
        if op_type.endswith("_grad") and GENERIC_GRAD_LOWERING is not None \
                and op_type[:-len("_grad")] in LOWERINGS:
            return GENERIC_GRAD_LOWERING
        raise NotImplementedError(
            f"op {op_type!r} has no lowering in the PyTorch port yet: "
            f"it comes with a later slice of the port ({len(LOWERINGS)} "
            f"ops available)") from None


class LoweringContext:
    """Environment for one block run.

    ``env`` maps var name -> tensor (last write wins, which reproduces the
    reference's scope-mutation semantics).  ``device`` is where ops that
    take no tensor input (``fill_constant``, random ops) create theirs.
    """

    def __init__(self, block, env: dict, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.block = block
        self.program = block.program
        self.env = env
        self.device = device
        self._generator = generator

    # -- values -----------------------------------------------------------
    def get(self, name: str):
        if name not in self.env:
            raise KeyError(
                f"op input {name!r} is not defined at this point in the program "
                "(not a feed, not in scope, not produced by an earlier op)"
            )
        return self.env[name]

    def get_opt(self, name: Optional[str]):
        if not name:
            return None
        return self.env.get(name)

    def set(self, name: str, value):
        self.env[name] = value

    # -- op slot helpers ---------------------------------------------------
    def in1(self, op, slot: str):
        names = op.inputs.get(slot, [])
        return self.get(names[0]) if names else None

    def in_list(self, op, slot: str) -> List:
        return [self.get(n) for n in op.inputs.get(slot, [])]

    def out_name(self, op, slot: str) -> Optional[str]:
        names = op.outputs.get(slot, [])
        return names[0] if names else None

    def set_out(self, op, slot: str, value):
        name = self.out_name(op, slot)
        if name is not None:
            self.env[name] = value

    # -- randomness --------------------------------------------------------
    def next_generator(self) -> torch.Generator:
        """The program's random stream (the JAX package's ``next_key``)."""
        if self._generator is None:
            raise RuntimeError(
                "program uses random ops but no generator was threaded")
        return self._generator
