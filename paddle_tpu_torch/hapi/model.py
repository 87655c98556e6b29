"""`paddle.Model`: the high-level train/eval/predict loop.

Counterpart of ``paddle_tpu/hapi/model.py`` (reference
python/paddle/hapi/model.py:819: prepare:1250, fit:1306, evaluate:1516,
predict:1617, save/load, train_batch/eval_batch), with both adapters:

- **dygraph** (the mode at construction is dygraph): batches run eagerly
  on the tape of ``dygraph/`` (``torch.autograd``), on the place.  A
  batch that is already a tensor on the card (``DataLoader(...,
  device_prefetch=True)``) reaches ``to_variable`` as it is, with no
  round trip through the host; host batches are numpy.
- **static** (constructed under ``enable_static()``, with ``inputs=``
  InputSpecs): ``prepare`` builds train, eval and predict programs once
  and the batches run through the ``Executor`` on the place, where each
  program's steps become CUDA-graph replays on the card
  (``framework/executor.py``).  The eval and predict programs are clones
  ``for_test`` of the forward, taken before the optimizer's ops join.

The per-step ``float(loss)`` and the metrics' host ``argsort`` are the
reference's own syncs.  The port's ``Executor.run`` is synchronous (the
JAX package's pipelined ``StepHandle`` window is ROADMAP Queue A item
4), so the static adapter's ``LazyLogs`` defer only the host-side
conversion of the fetched loss.  ``save``/``load`` pickle ``.pdparams``
and ``.pdopt`` dicts of numpy arrays, the JAX package's format: a file
written by either package's ``Model.save`` loads into the other's
``Model``.  ``save(training=False)`` exports a servable inference
model through ``jit.save`` (traced at the Model's ``inputs``).

One difference from the JAX package: under an ``LRScheduler`` the static
adapter writes the scheduler's current rate into its own scope before
each train step.  The JAX package's static optimizer writes it into the
global scope, which the Model's programs do not read, so there the rate
stays at its first value.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np
import torch

from ..dygraph import no_grad, to_variable
from ..metric import Metric
from .callbacks import config_callbacks


class InputSpec:
    """Reference paddle.static.InputSpec parity (shape/dtype/name)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


class _Deferred:
    """A not-yet-materialized log value (a thunk over a fetched value)."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self):
        return self.fn()


class LazyLogs(dict):
    """Batch logs whose values may be deferred: the static adapter's
    ``train_batch``/``eval_batch`` store the loss as a thunk, forced only
    when something reads it (a callback printing at ``log_freq``, the
    epoch-end history append).  The JAX package's executor returns lazy
    step handles there, so a deferred read keeps steps in flight; the
    port's run is synchronous, so only the host-side conversion waits.
    Reads materialize in place; ``raw()`` returns the thunk without
    forcing it (the evaluate loop defers its per-batch losses to one
    pass at epoch end)."""

    def _force(self, k, v):
        if isinstance(v, _Deferred):
            v = v()
            dict.__setitem__(self, k, v)
        return v

    def __getitem__(self, k):
        return self._force(k, dict.__getitem__(self, k))

    def get(self, k, default=None):
        if k in self:
            return self.__getitem__(k)
        return default

    def items(self):
        return [(k, self._force(k, dict.__getitem__(self, k)))
                for k in self]

    def values(self):
        return [v for _, v in self.items()]

    def raw(self, k, default=None):
        """The stored value — a ``_Deferred`` thunk if not yet forced."""
        return dict.get(self, k, default)

    def force(self):
        """Materialize every value in place (plain floats afterwards —
        safe to dict()/copy()/unpack)."""
        self.items()
        return self

    def copy(self):
        return dict(self.items())  # a snapshot never leaks thunks


def _callbacks_tolerate_lazy(cbks) -> bool:
    """Only the framework's own callbacks are KNOWN not to snapshot
    logs via dict(logs)/copy()/{**} (which bypass LazyLogs' lazy reads
    and would leak _Deferred thunks).  Any user callback gets fully
    materialized logs — correctness over overlap."""
    return all(type(c).__module__.startswith("paddle_tpu_torch.")
               for c in getattr(cbks, "callbacks", []))


class Model:
    """Mode follows the global graph mode at construction (reference
    hapi/model.py:819 picks _AdapterStatic vs dynamic the same way):
    under ``enable_static()`` the Model builds train/eval/predict
    Programs once in prepare() and drives them through the Executor (one
    compiled step per program, replayed as a CUDA graph on the card),
    while dygraph mode runs eager batches."""

    def __init__(self, network, inputs=None, labels=None):
        from ..dygraph.base import in_dygraph_mode

        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._static_mode = not in_dygraph_mode()
        self._st = None  # static-mode program bundle

    # -- setup -----------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        else:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        for m in self._metrics:
            assert isinstance(m, Metric), "metrics must be paddle.metric.Metric"
        if self._static_mode:
            self._build_static()
        return self

    # -- static adapter ---------------------------------------------------
    def _swap_params_static(self):
        """Swap every eager parameter for a static graph Parameter (same
        name, NumpyArrayInitializer from the live value) for the
        duration of a program build, otherwise the dual dispatch bakes
        the weights as inline constants and nothing trains; and every
        persistable buffer (batch norm's running statistics) for a
        persistable var of the buffer's name, which the op updates in
        place.  The JAX package swaps only the parameters, so its static
        adapter fails on a batch-norm network (``nn/functional.py``
        ``batch_norm``).  Returns the restore list."""
        from ..initializer import NumpyArrayInitializer
        from ..layer_helper import LayerHelper
        from ..param_attr import ParamAttr

        helper = LayerHelper("hapi_static")
        saved = []
        for _, sub in self.network.named_sublayers(include_self=True):
            for pname, p in list(sub._parameters.items()):
                if p is None:
                    continue
                arr = np.asarray(p.numpy())
                sv = helper.create_parameter(
                    attr=ParamAttr(name=p.name,
                                   initializer=NumpyArrayInitializer(arr),
                                   trainable=getattr(p, "trainable", True)),
                    shape=list(arr.shape), dtype=str(arr.dtype))
                saved.append((sub._parameters, pname, p))
                sub._parameters[pname] = sv
            for bname, b in list(sub._buffers.items()):
                if b is None or bname in sub._non_persistable_buffer_names:
                    continue
                arr = np.asarray(b.numpy())
                sv = helper.create_global_variable(
                    list(arr.shape), dtype=str(arr.dtype), name=b.name,
                    initializer=NumpyArrayInitializer(arr))
                saved.append((sub._buffers, bname, b))
                sub._buffers[bname] = sv
        return saved

    @staticmethod
    def _restore_params(saved):
        for store, pname, p in saved:
            store[pname] = p

    def _state_tensors(self):
        """The network's parameters and persistable buffers, the eager
        tensors whose names the static programs' state vars carry."""
        return list(self.network.state_dict().values())

    def _build_static(self):
        from .. import layers
        from ..dygraph.base import current_device
        from ..framework.executor import Executor
        from ..framework.place import CPUPlace, CUDAPlace
        from ..framework.program import Program, program_guard
        from ..framework.scope import Scope

        if not self._inputs:
            raise ValueError(
                "static-graph Model needs inputs=[InputSpec(...)] at "
                "construction (reference hapi/model.py static adapter)")

        def feeds(specs, prefix):
            vars_ = []
            for i, s in enumerate(specs or []):
                shape = list(s.shape)
                if shape and (shape[0] is None or shape[0] == -1):
                    shape = shape[1:]  # layers.data adds the batch dim
                vars_.append(layers.data(s.name or f"{prefix}_{i}", shape,
                                         dtype=s.dtype))
            return vars_

        st = {"startup": Program(), "train": Program()}
        with program_guard(st["train"], st["startup"]):
            saved = self._swap_params_static()
            try:
                ins = feeds(self._inputs, "input")
                lbs = feeds(self._labels, "label")
                outs = self.network(*ins)
                outs_l = list(outs) if isinstance(outs, (list, tuple)) \
                    else [outs]
                st["feed_names"] = [v.name for v in ins]
                st["label_names"] = [v.name for v in lbs]
                st["out_names"] = [o.name for o in outs_l]
                loss = None
                if self._loss is not None and lbs:
                    loss = self._loss(*outs_l, *lbs)
                    st["loss_name"] = loss.name
                # eval shares the graph with is_test flipped, cloned
                # BEFORE the optimizer ops join
                st["eval"] = st["train"].clone(for_test=True)
                if self._optimizer is not None and loss is not None:
                    self._optimizer.minimize(
                        loss, startup_program=st["startup"])
            finally:
                self._restore_params(saved)
        # predict program: same network, no labels; parameters keep
        # their names, so it reads the one scope the train startup fills
        st["predict"] = Program()
        with program_guard(st["predict"], Program()):
            saved = self._swap_params_static()
            try:
                ins = feeds(self._inputs, "input")
                outs = self.network(*ins)
                outs_l = list(outs) if isinstance(outs, (list, tuple)) \
                    else [outs]
                st["pred_feed_names"] = [v.name for v in ins]
                st["pred_out_names"] = [o.name for o in outs_l]
            finally:
                self._restore_params(saved)
        st["predict"] = st["predict"].clone(for_test=True)
        st["scope"] = Scope()
        dev = current_device()
        st["exe"] = Executor(CPUPlace() if dev.type == "cpu"
                             else CUDAPlace(dev.index))
        st["exe"].run(st["startup"], scope=st["scope"])
        st["lr_var"] = getattr(getattr(self._optimizer, "_fluid_opt", None),
                               "_lr_var", None)
        st["lr"] = None
        self._st = st

    def _sync_scope_to_network(self):
        """After static training, push scope values back into the eager
        parameters and buffers (names tie them) so save()/state_dict see
        the result."""
        scope = self._st["scope"]
        for p in self._state_tensors():
            v = scope.find_var(p.name) if scope.has_var(p.name) else None
            if v is not None:
                p.set_value(v.get_tensor())

    def _static_feed(self, names, data):
        vals = data if isinstance(data, (list, tuple)) else [data]
        return {n: _array(v) for n, v in zip(names, vals)}

    def _static_lr(self):
        """Write the scheduler's current rate into the Model's scope
        when it changed (see the module docstring)."""
        from ..optimizer_lr import LRScheduler

        st = self._st
        sched = getattr(self._optimizer, "_learning_rate", None)
        if st["lr_var"] is None or not isinstance(sched, LRScheduler) \
                or st["lr"] == sched.last_lr:
            return
        st["lr"] = sched.last_lr
        st["scope"].set_var(st["lr_var"].name,
                            np.asarray([sched.last_lr], "float32"),
                            st["exe"].place)

    # -- single-batch steps ----------------------------------------------
    def _to_vars(self, data):
        return [to_variable(_array(d)) for d in _as_list(data)]

    def train_batch(self, inputs, labels=None):
        if self._static_mode:
            return self._static_batch("train", inputs, labels)
        self.network.train()
        ins = self._to_vars(inputs)
        outs = self.network(*ins)
        outs_list = outs if isinstance(outs, (list, tuple)) else [outs]
        logs = {}
        if labels is not None and self._loss is not None:
            lbs = self._to_vars(labels)
            loss = self._loss(*outs_list, *lbs)
            loss.backward()
            self._optimizer.step()
            self._optimizer.clear_grad()
            logs["loss"] = float(np.asarray(loss.numpy()).ravel()[0])
            for m in self._metrics:
                _metric_update(m, outs_list[0], lbs[0])
        return logs

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        if self._static_mode:
            return self._static_batch("eval", inputs, labels)
        self.network.eval()
        ins = self._to_vars(inputs)
        outs = self.network(*ins)
        outs_list = outs if isinstance(outs, (list, tuple)) else [outs]
        logs = {}
        if labels is not None:
            lbs = self._to_vars(labels)
            if self._loss is not None:
                loss = self._loss(*outs_list, *lbs)
                logs["loss"] = float(np.asarray(loss.numpy()).ravel()[0])
            for m in self._metrics:
                _metric_update(m, outs_list[0], lbs[0])
        return logs

    @no_grad()
    def predict_batch(self, inputs):
        if self._static_mode:
            st = self._require_static()
            feed = self._static_feed(st["pred_feed_names"], inputs)
            outs = st["exe"].run(st["predict"], feed=feed,
                                 fetch_list=st["pred_out_names"],
                                 scope=st["scope"])
            return [np.asarray(o) for o in outs]
        self.network.eval()
        outs = self.network(*self._to_vars(inputs))
        outs_list = outs if isinstance(outs, (list, tuple)) else [outs]
        return [np.asarray(o.numpy()) for o in outs_list]

    def _require_static(self):
        if self._st is None:
            raise RuntimeError("static-graph Model: call prepare() first")
        return self._st

    def _static_batch(self, kind, inputs, labels):
        st = self._require_static()
        feed = self._static_feed(st["feed_names"], inputs)
        if labels is not None:
            feed.update(self._static_feed(st["label_names"], labels))
        fetch = list(st["out_names"])
        has_loss = "loss_name" in st and labels is not None
        if has_loss:
            fetch.append(st["loss_name"])
        if kind == "train":
            self._static_lr()
        prog = st["train"] if kind == "train" else st["eval"]
        outs = st["exe"].run(prog, feed=feed, fetch_list=fetch,
                             scope=st["scope"])
        logs = LazyLogs()
        if has_loss:
            # the thunk holds only the loss, not the whole fetch list:
            # evaluate keeps one thunk per batch until its end
            loss_ref = outs[-1]
            logs["loss"] = _Deferred(
                lambda: float(np.asarray(loss_ref).ravel()[0]))
        if labels is not None and self._metrics:
            from ..dygraph.tensor import Tensor

            # the metrics read host tensors (the fetches already are)
            pred = Tensor(torch.from_numpy(np.asarray(outs[0])))
            lbl = Tensor(_host(_as_list(labels)[0]))
            for m in self._metrics:
                _metric_update(m, pred, lbl)
        return logs

    # -- loops -----------------------------------------------------------
    def _as_loader(self, data, batch_size, shuffle, drop_last=False,
                   num_workers=0):
        from ..io import DataLoader, Dataset

        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data  # any iterable of batches

    @staticmethod
    def _split_batch(batch):
        """(x, y) convention: last element is the label."""
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return list(batch[:-1]), [batch[-1]]
        return [batch], None

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None):
        loader = self._as_loader(train_data, batch_size, shuffle,
                                 drop_last=drop_last,
                                 num_workers=num_workers)
        steps = None
        try:
            steps = len(loader)
        except TypeError:
            pass
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, verbose=verbose,
                                log_freq=log_freq, save_dir=save_dir,
                                save_freq=save_freq,
                                metrics=[n for m in self._metrics
                                         for n in _as_list(m.name())])
        self.stop_training = False
        cbks.on_train_begin()
        lazy_ok = _callbacks_tolerate_lazy(cbks)
        history = {"loss": []}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                xs, ys = self._split_batch(batch)
                logs = self.train_batch(xs, ys)
                for m in self._metrics:
                    for n, v in zip(_as_list(m.name()), _as_list(m.accumulate())):
                        logs[n] = v
                if not lazy_ok and isinstance(logs, LazyLogs):
                    logs.force()  # user callbacks see plain floats
                cbks.on_train_batch_end(step, logs)
            history["loss"].append(logs.get("loss"))
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0, _callbacks=cbks)
                for k, v in eval_logs.items():
                    history.setdefault("eval_" + k, []).append(v)
            if self.stop_training:
                break
        cbks.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _callbacks=None):
        loader = self._as_loader(eval_data, batch_size, False,
                                 num_workers=num_workers)
        cbks = _callbacks or config_callbacks(callbacks, model=self,
                                              verbose=verbose)
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        lazy_ok = _callbacks_tolerate_lazy(cbks)
        logs = {}
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            xs, ys = self._split_batch(batch)
            logs = self.eval_batch(xs, ys)
            if not lazy_ok and isinstance(logs, LazyLogs):
                logs.force()
            if "loss" in logs:
                # keep the thunk: all batch losses sync in ONE pass at
                # the end instead of serializing the eval pipeline
                losses.append(logs.raw("loss")
                              if isinstance(logs, LazyLogs)
                              else logs["loss"])
            cbks.on_eval_batch_end(step, logs)
        if losses:
            logs["loss"] = float(np.mean(
                [v() if isinstance(v, _Deferred) else v for v in losses]))
        for m in self._metrics:
            for n, v in zip(_as_list(m.name()), _as_list(m.accumulate())):
                logs[n] = v
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False,
                                 num_workers=num_workers)
        outputs = []
        for batch in loader:
            xs, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(xs))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs]) for i in range(n_out)]
        return outputs

    # -- persistence -----------------------------------------------------
    def save(self, path, training=True):
        """Reference Model.save: ``training=True`` saves the state dict
        (``path.pdparams``) and the optimizer's state (``path.pdopt``),
        pickled dicts of numpy arrays; ``training=False`` exports a
        servable inference model via the trace-based ``jit.save``
        (reference hapi/model.py:199)."""
        if not training:
            from .. import jit

            if not self._inputs:
                raise ValueError(
                    "Model.save(training=False) needs the Model to be "
                    "constructed with `inputs=[InputSpec(...)]` so the "
                    "forward can be traced for export")
            if self._static_mode and self._st is not None:
                # trained values live in the executor scope; the traced
                # export reads the eager parameters
                self._sync_scope_to_network()
            was_training = getattr(self.network, "training", False)
            self.network.eval()
            try:
                jit.save(self.network, path, input_spec=self._inputs)
            finally:
                if was_training:
                    self.network.train()
            return
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        if self._static_mode and self._st is not None:
            self._sync_scope_to_network()
        sd = {k: np.asarray(v.numpy())
              for k, v in self.network.state_dict().items()}
        with open(path + ".pdparams", "wb") as f:
            pickle.dump(sd, f)
        if self._optimizer is not None \
                and hasattr(self._optimizer, "state_dict"):
            od = {k: _host(v).numpy()
                  for k, v in self._optimizer.state_dict().items()
                  if not isinstance(v, dict)}
            with open(path + ".pdopt", "wb") as f:
                pickle.dump(od, f)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        with open(path + ".pdparams", "rb") as f:
            sd = pickle.load(f)
        missing, unexpected = self.network.set_state_dict(sd)
        if not skip_mismatch and (missing or unexpected):
            raise RuntimeError(
                f"state dict mismatch: missing={missing}, "
                f"unexpected={unexpected} (pass skip_mismatch=True to ignore)")
        if self._static_mode and self._st is not None:
            # push loaded values into the executor scope (names tie the
            # eager parameters to the static vars)
            scope, place = self._st["scope"], self._st["exe"].place
            for p in self._state_tensors():
                scope.set_var(p.name, p._value.detach().clone(), place)
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            with open(path + ".pdopt", "rb") as f:
                od = pickle.load(f)
            if hasattr(self._optimizer, "set_state_dict"):
                self._optimizer.set_state_dict(od)

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .model_stat import summary as _summary

        return _summary(self.network, input_size=input_size, dtypes=dtype)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _array(x):
    """A batch leaf for the step: a torch tensor (already on the card
    after device prefetch) as it is, anything else as numpy."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _host(x):
    """A torch tensor on the host for ``x`` (a tensor anywhere, or an
    array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.as_tensor(np.asarray(x))


def _metric_update(metric, pred, label):
    """compute() may return one value or a (pred, label)-style tuple; the
    reference unpacks it into update() (hapi/model.py metric handling)."""
    res = metric.compute(pred, label)
    if isinstance(res, tuple):
        metric.update(*res)
    else:
        metric.update(res)
