"""Trace-based dygraph->static export: TracedLayer / to_static / jit.save.

Counterpart of ``paddle_tpu/dygraph/jit.py`` (role parity: reference
python/paddle/fluid/dygraph/jit.py, ``save``:466, ``TracedLayer``:995,
over the C++ ``ProgramDescTracer``).  Eager dispatch funnels every op
through ``eager.run_op`` with IR op names, slots and attrs, so a trace
records each eager op into a ``Program`` as it runs; ``dy2static``
rewrites Python ``if``/``while``/``for`` over tensors first, so that
data-dependent control flow records ``cond_pair``/``while`` ops with
sub-blocks instead of the branch the example took.

Running a traced program: ``TracedLayer.__call__`` (and so
``StaticFunction``, the ``to_static`` wrapper) goes through the port's
``Executor`` on the device where the traced layer's parameters live.
On the card a program with no control flow therefore runs as a captured
CUDA graph, the executor's route for every program (its first call
eager, its second captured, later calls replayed); a program with
control flow or a shape tensor runs eagerly (``capture_reason``).

Parameters are snapshots: the first sighting of a parameter in a trace
clones its value on its own device into the ``TracedLayer``'s scope, as
the JAX package copies it to the host; a later change to the dygraph
parameter does not reach the traced program.  ``StaticFunction`` keys
its traces by the inputs' shapes, dtypes and device, so a trace made on
the card is never replayed on CPU inputs.  ``jit.save`` exports through
``fluid.io.save_inference_model``; ``jit.load`` serves the directory
through ``inference.Predictor`` on the current dygraph device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework import dtypes, unique_name
from ..framework.program import Program
from .tensor import Tensor, _wrap

# The active recorder lives in eager._TRACE_REC (one trace at a time,
# like the reference's ProgramDescTracer guard) so the eager hot path
# checks a plain module global instead of importing this module per op.


def _dtype_str(t: Tensor) -> str:
    return dtypes.to_str(t._value.dtype)


class _ProgramRecorder:
    """Records eager ops into a Program while they execute."""

    def __init__(self, snapshot: bool = True):
        self.program = Program()
        self._snapshot = snapshot
        self.block = self.program.global_block
        self._names: Dict[int, str] = {}  # id(Tensor) -> var name
        # id() is only unique while the object lives: hold a reference to
        # every traced tensor or a collected intermediate's recycled id
        # would alias a later tensor to a stale var
        self._keep: List[Tensor] = []
        self.feed_names: List[str] = []
        self.param_values: Dict[str, torch.Tensor] = {}

    # -- var management -----------------------------------------------
    def declare_input(self, t: Tensor) -> str:
        name = unique_name.generate("trace_feed")
        self.block.create_var(name=name, shape=list(t.shape),
                              dtype=_dtype_str(t), stop_gradient=True)
        self._names[id(t)] = name
        self._keep.append(t)
        self.feed_names.append(name)
        return name

    def _var_for(self, t: Tensor) -> str:
        name = self._names.get(id(t))
        if name is not None:
            return name
        # first sighting mid-trace: a parameter or a captured constant,
        # either way persistable state saved with the model.  Declared in
        # the ROOT block even when captured inside a cond/while sub-block:
        # persistable state is global, and the export saves root vars.
        if getattr(t, "persistable", False) and t.name:
            name = t.name
        else:
            name = unique_name.generate("trace_const")
        self.program.global_block.create_var(
            name=name, shape=list(t.shape), dtype=_dtype_str(t),
            persistable=True, stop_gradient=True)
        self._names[id(t)] = name
        self._keep.append(t)
        if self._snapshot:
            # a snapshot on the tensor's own device, no host round trip
            self.param_values[name] = t._value.detach().clone()
        return name

    def _out_var(self, t: Tensor) -> str:
        name = unique_name.generate("trace_tmp")
        self.block.create_var(name=name, shape=list(t.shape),
                              dtype=_dtype_str(t), stop_gradient=False)
        self._names[id(t)] = name
        self._keep.append(t)
        return name

    def alias(self, produced: Tensor, holder: Tensor):
        """trace_op-style value hand-off: ``holder`` now carries the value
        ``produced`` had; later ops reference ``holder``."""
        if id(produced) in self._names:
            self._names[id(holder)] = self._names[id(produced)]
            self._keep.append(holder)

    def name_of(self, t: Tensor) -> Optional[str]:
        return self._names.get(id(t))

    # -- control-flow capture (dy2static convert shims) ----------------
    def ensure_name(self, t: Tensor) -> str:
        """Var name for ``t``, registering it as a captured constant if
        the trace has not seen it (same policy as op-input capture)."""
        return self._var_for(t)

    def bind(self, t: Tensor, name: str):
        """Re-point ``t`` at ``name`` (e.g. a cond/while output var)."""
        self._names[id(t)] = name
        self._keep.append(t)

    def new_parent_var(self, parent, t: Tensor) -> str:
        name = unique_name.generate("ctrl_out")
        parent.create_var(name=name, shape=list(t.shape),
                          dtype=_dtype_str(t), stop_gradient=False)
        return name

    def begin_sub_block(self):
        sub = self.program._create_block()
        self.block = sub
        return sub

    def end_sub_block(self, parent):
        self.program._rollback()
        self.block = parent

    # -- op recording --------------------------------------------------
    def record(self, op_type: str, tensor_inputs: Dict[str, List[Tensor]],
               attrs: dict, result: Dict[str, object],
               out_slots: Sequence[str]):
        in_names = {slot: [self._var_for(t) for t in ts]
                    for slot, ts in tensor_inputs.items()}
        out_names: Dict[str, List[str]] = {}
        for slot in out_slots:
            v = result.get(slot)
            ts = v if isinstance(v, (list, tuple)) else [v]
            out_names[slot] = [self._out_var(t) for t in ts if t is not None]
        self.block.append_op(op_type, in_names, out_names, dict(attrs or {}))


def _recorder() -> Optional[_ProgramRecorder]:
    from . import eager

    return eager._TRACE_REC


class _trace_guard:
    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        from . import eager

        if eager._TRACE_REC is not None:
            raise RuntimeError("a dygraph trace is already active")
        eager._TRACE_REC = self.rec
        return self.rec

    def __exit__(self, *exc):
        from . import eager

        eager._TRACE_REC = None
        return False


def _as_tensors(inputs):
    return [x if isinstance(x, Tensor) else Tensor(x) for x in inputs]


def trace(layer_or_fn, inputs, snapshot: bool = True):
    """Run ``layer_or_fn(*inputs)`` once, recording every op into a
    Program.  Returns (outputs, recorder, fetch names).  With
    ``snapshot`` False the recorder keeps no copy of the parameters (a
    caller that needs only the program, as ``flops`` does).

    The callable is AST-converted first (dy2static), so Python
    ``if``/``while``/``for`` over tensor values record real cond/while
    ops instead of baking in the traced branch."""
    from .dy2static import convert_callable

    layer_or_fn = convert_callable(layer_or_fn)
    inputs = _as_tensors(list(inputs))
    rec = _ProgramRecorder(snapshot)
    for t in inputs:
        rec.declare_input(t)
    with _trace_guard(rec):
        outs = layer_or_fn(*inputs)
    flat = outs if isinstance(outs, (list, tuple)) else [outs]
    fetch = []
    for o in flat:
        name = rec.name_of(o)
        if name is None:
            raise RuntimeError(
                "trace output was not produced by recorded ops (did the "
                "forward use a non-IR escape hatch like tensor indexing?)")
        fetch.append(name)
    return outs, rec, fetch


def _place_of(values, fallback: torch.device):
    """The executor place for a traced program: where its state lives
    (the parameters' device), else ``fallback`` (the inputs')."""
    from ..framework.place import CPUPlace, CUDAPlace

    dev = next((v.device for v in values if isinstance(v, torch.Tensor)),
               fallback)
    if dev.type == "cuda":
        return CUDAPlace(dev.index if dev.index is not None
                         else torch.cuda.current_device())
    return CPUPlace()


class TracedLayer:
    """Reference fluid.dygraph.TracedLayer (jit.py:995): trace once, then
    run / export the static program."""

    def __init__(self, program, feed_names, fetch_names, param_values,
                 device: Optional[torch.device] = None):
        self.program = program
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._param_values = dict(param_values)
        self._device = device
        self._exe = None
        self._scope = None

    @staticmethod
    def trace(layer, inputs):
        inputs = _as_tensors(list(inputs))
        outs, rec, fetch = trace(layer, inputs)
        device = inputs[0]._value.device if inputs else None
        tl = TracedLayer(rec.program, rec.feed_names, fetch,
                         rec.param_values, device)
        return outs, tl

    def _ensure_exe(self):
        from ..framework.executor import Executor
        from ..framework.scope import Scope
        from . import base

        if self._exe is None:
            place = _place_of(self._param_values.values(),
                              self._device or base.current_device())
            self._exe = Executor(place)
            self._scope = Scope()
            for name, val in self._param_values.items():
                self._scope.set_var(name, val)
        return self._exe, self._scope

    def __call__(self, *inputs):
        exe, scope = self._ensure_exe()
        feed = {n: (t._value.detach() if isinstance(t, Tensor)
                    else np.asarray(t))
                for n, t in zip(self._feed_names, inputs)}
        outs = exe.run(self.program, feed=feed,
                       fetch_list=self._fetch_names, scope=scope,
                       return_numpy=False)
        return [_wrap(o) for o in outs]

    def save_inference_model(self, path, feed=None, fetch=None):
        """Export (program, params) servable by inference.Predictor
        (reference TracedLayer.save_inference_model)."""
        from ..fluid import io as fluid_io
        from ..fluid import scope_guard

        exe, scope = self._ensure_exe()
        feed_names = ([self._feed_names[i] for i in feed]
                      if feed else self._feed_names)
        fetch_names = ([self._fetch_names[i] for i in fetch]
                       if fetch else self._fetch_names)
        with scope_guard(scope):
            fluid_io.save_inference_model(
                path, feed_names,
                [self.program.global_block.var(n) for n in fetch_names],
                exe, main_program=self.program)


class StaticFunction:
    """``@to_static`` wrapper: traces on the first call per input
    signature (shapes, dtypes, device) and afterwards runs the traced
    program (reference dygraph_to_static ProgramTranslator)."""

    def __init__(self, fn, input_spec=None):
        from .dy2static import convert_callable

        self._fn = convert_callable(fn)
        self._input_spec = input_spec
        self._traced: Dict[tuple, TracedLayer] = {}

    def _key(self, inputs):
        return tuple((tuple(t.shape), t._value.dtype, t._value.device)
                     for t in inputs)

    def __call__(self, *inputs):
        if _recorder() is not None:
            # nested inside an active trace: run the Python body eagerly
            # so its ops are recorded into the OUTER program
            return self._fn(*inputs)
        inputs = _as_tensors(list(inputs))
        key = self._key(inputs)
        tl = self._traced.get(key)
        if tl is None:
            _, tl = TracedLayer.trace(self._fn, inputs)
            self._traced[key] = tl
        outs = tl(*inputs)
        return outs[0] if len(outs) == 1 else outs

    @property
    def concrete_program(self):
        if not self._traced:
            raise RuntimeError("call the function once (or pass input_spec "
                               "to jit.save) before reading the program")
        return next(iter(self._traced.values()))


def to_static(fn=None, input_spec=None):
    """Decorator parity with paddle.jit.to_static (reference
    dygraph_to_static/program_translator.py declarative)."""
    if fn is None:
        return lambda f: StaticFunction(f, input_spec)
    return StaticFunction(fn, input_spec)


declarative = to_static


def _example_from_spec(spec):
    from ..hapi.model import InputSpec

    if isinstance(spec, InputSpec):
        shape = [1 if (s is None or int(s) < 0) else int(s)
                 for s in spec.shape]
        return Tensor(np.zeros(shape, dtypes.to_np(spec.dtype)))
    if isinstance(spec, Tensor):
        return spec
    return Tensor(spec)


def save(layer, path, input_spec=None):
    """paddle.jit.save (reference dygraph/jit.py:466): trace ``layer`` and
    export an inference model to ``path`` (dir with model+params)."""
    if isinstance(layer, StaticFunction):
        fn = layer._fn
        if input_spec is None:
            input_spec = layer._input_spec  # @to_static(input_spec=...)
    elif callable(layer):
        fn = layer
    else:
        raise TypeError(f"cannot jit.save {type(layer)}")
    if input_spec is None:
        raise ValueError(
            "jit.save needs input_spec (InputSpec list or example tensors) "
            "to trace the forward")
    inputs = [_example_from_spec(s) for s in input_spec]
    _, tl = TracedLayer.trace(fn, inputs)
    tl.save_inference_model(path)
    return tl


class TranslatedLayer:
    """Loaded counterpart of jit.save (reference TranslatedLayer): a
    callable over a ``Predictor``, whose outputs stay on its device."""

    def __init__(self, predictor):
        self._predictor = predictor

    def __call__(self, *inputs):
        p = self._predictor
        if len(inputs) != len(p._feed_names):
            raise ValueError(f"expected {len(p._feed_names)} inputs "
                             f"{p._feed_names}, got {len(inputs)}")
        feed = {n: (t._value.detach() if isinstance(t, Tensor)
                    else np.asarray(t))
                for n, t in zip(p._feed_names, inputs)}
        outs = p._exe.run(p._program, feed=feed,
                          fetch_list=p._fetch_targets, scope=p._scope,
                          return_numpy=False)
        ts = [_wrap(o) for o in outs]
        return ts[0] if len(ts) == 1 else ts

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("a loaded inference program cannot be trained; "
                           "retrain from the dygraph Layer and re-save")


def load(path):
    """paddle.jit.load: inference model dir -> callable TranslatedLayer,
    served on the current dygraph device (``set_device``)."""
    from ..inference import Config, create_predictor
    from . import base

    cfg = Config(path)
    dev = base.current_device()
    if dev.type == "cpu":
        cfg.disable_gpu()
    else:
        cfg.enable_tpu(dev.index or 0)
    return TranslatedLayer(create_predictor(cfg))
