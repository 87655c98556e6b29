"""fluid.io: static-graph checkpointing + inference export.

Counterpart of ``paddle_tpu/fluid/io.py`` (role parity: reference
python/paddle/fluid/io.py — save_vars:407, save_params:585,
save_persistables:620, load_vars:712, load_params:946,
load_persistables:994, save_inference_model:1198,
load_inference_model:1424).  Same architecture: the helpers build a small
program of save/load ops and run it through the Executor, which
interprets such programs on the host (``framework/executor.py``
``HOST_OPS``; files in ``framework/var_io.py``'s format).

One change from the JAX package: ``__model__`` is written and read by
the port's own wire codec (``framework/ir_wire.py``), not by protobuf,
which the hosts the port runs on need not have; the bytes are the same
format, so a model saved by either package loads in the other.
``prune_program`` slices an op that owns sub-blocks by what they read
from its surroundings too (``framework/executor.op_reads``), as the
JAX package's does.
"""
from __future__ import annotations

import os
from typing import List

from ..framework.executor import op_reads
from ..framework.program import Parameter, Program, Variable

MODEL_FILENAME = "__model__"


def is_parameter(var) -> bool:
    return isinstance(var, Parameter) or getattr(var, "is_parameter", False)


def is_persistable(var) -> bool:
    if var.name in ("feed", "fetch") or var.name.startswith("@"):
        return False
    return bool(getattr(var, "persistable", False))


def _collect_vars(main_program, vars=None, predicate=None) -> List[Variable]:
    if vars is not None:
        out = []
        for v in vars:
            out.append(main_program.global_block.var(v)
                       if isinstance(v, str) else v)
        return out
    pred = predicate or is_persistable
    return [v for v in main_program.global_block.vars.values() if pred(v)]


def _io_program(var_list, dirname, filename, op_type) -> Program:
    """Build the save/load program (reference io.py save_vars builds the
    same shape of program with save/save_combine ops)."""
    prog = Program()
    block = prog.global_block
    names = []
    for v in var_list:
        block.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                         persistable=True)
        names.append(v.name)
    if filename is None:
        for n in names:
            path = os.path.join(dirname, n)
            if op_type == "save":
                block.append_op("save", {"X": [n]}, {},
                                {"file_path": path})
            else:
                block.append_op("load", {}, {"Out": [n]},
                                {"file_path": path})
    else:
        path = os.path.join(dirname, filename)
        if op_type == "save":
            block.append_op("save_combine", {"X": names}, {},
                            {"file_path": path})
        else:
            block.append_op("load_combine", {}, {"Out": names},
                            {"file_path": path})
    return prog


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    from ..framework.program import default_main_program

    main_program = main_program or default_main_program()
    var_list = _collect_vars(main_program, vars, predicate)
    if not var_list:
        return
    os.makedirs(dirname, exist_ok=True)
    executor.run(_io_program(var_list, dirname, filename, "save"))


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    from ..framework.program import default_main_program

    main_program = main_program or default_main_program()
    var_list = _collect_vars(main_program, vars, predicate)
    if not var_list:
        return
    executor.run(_io_program(var_list, dirname, filename, "load"))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


# ---------------------------------------------------------------------------
# inference export (reference io.py:1198/1424)
# ---------------------------------------------------------------------------


def prune_program(program: Program, feed_names, target_names,
                  for_test: bool = False) -> Program:
    """Backward-slice the program to the ops needed for target_names given
    feed_names (reference framework/prune.cc via Executor.run(use_prune)).
    Unreferenced vars (e.g. optimizer state) are dropped too, so the slice
    carries exactly the serving surface.  One clone total."""
    pruned = program.clone(for_test=for_test)
    block = pruned.global_block

    feed_set = set(feed_names)
    needed = set(target_names)
    kept = []
    for op in reversed(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        reads = op_reads(pruned, op)
        if set(op.output_arg_names()) & needed:
            kept.append(op)
            for n in reads:
                if n not in feed_set:
                    needed.add(n)
    block.ops[:] = list(reversed(kept))
    referenced = set(feed_set) | set(target_names)
    for op in block.ops:
        referenced.update(op_reads(pruned, op))
        referenced.update(op.output_arg_names())
    block.vars = {n: v for n, v in block.vars.items() if n in referenced}
    pruned._bump()
    missing = [n for n in target_names
               if not any(n in op.output_arg_names() for op in block.ops)
               and n not in feed_set]
    if missing:
        raise ValueError(
            f"target vars {missing} are not produced by the program given "
            f"feeds {sorted(feed_set)}")
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """Export a serve-ready (program, params) pair (reference io.py:1198).

    The program is clone(for_test=True)'d (BN/dropout to inference
    behavior) and pruned to the feed->target slice; feed/fetch names are
    stored as program-level fields of the serialized ``ProgramDef``."""
    from ..framework.ir_wire import encode_program
    from ..framework.program import default_main_program

    main_program = main_program or default_main_program()
    target_vars = [v if isinstance(v, Variable)
                   else main_program.global_block.var(v)
                   for v in target_vars]
    target_names = [v.name for v in target_vars]

    infer_prog = prune_program(main_program, feeded_var_names, target_names,
                               for_test=True)
    infer_prog._feed_names = list(feeded_var_names)
    infer_prog._fetch_names = list(target_names)

    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or MODEL_FILENAME)
    with open(model_path, "wb") as f:
        f.write(encode_program(infer_prog, feeded_var_names, target_names))
    if not program_only:
        save_vars(executor, dirname, infer_prog, predicate=is_persistable,
                  filename=params_filename)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Returns [program, feed_names, fetch_targets] (reference io.py:1424)."""
    from ..framework.ir_wire import decode_program

    model_path = os.path.join(dirname, model_filename or MODEL_FILENAME)
    with open(model_path, "rb") as f:
        data = f.read()
    program, feed_names, fetch_names = decode_program(data)
    program._feed_names = feed_names
    program._fetch_names = fetch_names
    load_vars(executor, dirname, program, predicate=is_persistable,
              filename=params_filename)
    fetch_targets = [program.global_block.var(n) for n in fetch_names]
    return [program, feed_names, fetch_targets]
