"""High-level API callbacks (reference python/paddle/hapi/callbacks.py).

Counterpart of ``paddle_tpu/hapi/callbacks.py``.  ``ModelCheckpoint``
saves through ``paddle_tpu_torch.ckpt`` (atomic epoch commits,
retention, async writes), or with ``legacy_format=True`` through
synchronous ``Model.save`` per epoch (the reference's layout).
``BenchmarkCallback`` reads the port's
``observe`` histograms and, in static mode, the executor's step timer
(``observe/step_stats.py``).
"""
from __future__ import annotations

import numbers
import os
import time

from ..observe.histogram import histogram, stat_time
from ..observe.step_stats import mfu_estimate, step_timer


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                parts.append(f"{k}: {v:.4f}")
            elif hasattr(v, "__len__") and len(v) == 1:
                parts.append(f"{k}: {float(v[0]):.4f}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and (step + 1) % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps or '?'} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """Epoch checkpointing through ``paddle_tpu_torch.ckpt``: commits are
    atomic (manifest + rename: a killed run can't leave a torn epoch
    dir), ``keep_n`` retention-GCs old epochs, and ``async_save=True``
    hands serialization + writes to the background writer so the train
    loop only blocks for the state capture.  ``on_train_end`` drains
    pending saves and still writes the ``final`` export via
    ``Model.save``.  ``restore_latest(model)`` reloads the newest intact
    epoch (falling back past corrupt ones).

    On-disk layout: epochs land as manager ``step_<epoch>`` dirs (npz
    shards + manifest), not the reference's ``save_dir/{epoch}``
    ``Model.save`` files.  ``legacy_format=True`` keeps that per-epoch
    layout (synchronous ``Model.save``, no atomicity or retention)."""

    def __init__(self, save_freq=1, save_dir=None, keep_n=0,
                 async_save=None, legacy_format=False):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.keep_n = keep_n
        self.async_save = async_save
        self.legacy_format = legacy_format
        self._manager = None

    def _mgr(self):
        if self._manager is None:
            from ..ckpt import CheckpointManager

            self._manager = CheckpointManager(
                self.save_dir, keep_n=self.keep_n,
                async_save=self.async_save)
        return self._manager

    def _capture(self):
        """Host copies of the network's parameters and buffers and the
        optimizer's state, prefixed so one flat dict carries both;
        dict-valued optimizer entries (the LR scheduler's state) return
        apart, to ride the checkpoint's JSON host state."""
        import json
        import logging

        model = self.model
        if getattr(model, "_static_mode", False) and model._st is not None:
            model._sync_scope_to_network()
        state = {"param/" + k: _host_tensor(v)
                 for k, v in model.network.state_dict().items()}
        opt_json = {}
        opt = getattr(model, "_optimizer", None)
        if opt is not None and hasattr(opt, "state_dict"):
            for k, v in opt.state_dict().items():
                if isinstance(v, dict):
                    # numpy scalars -> floats: this rides the JSON host
                    # state; an entry JSON cannot hold is dropped with a
                    # warning rather than ending training at an epoch
                    try:
                        opt_json[k] = json.loads(
                            json.dumps(v, default=float))
                    except (TypeError, ValueError):
                        logging.getLogger(__name__).warning(
                            "ModelCheckpoint: optimizer state %r is not "
                            "JSON-serializable; it will not ride the "
                            "checkpoint", k)
                else:
                    state["opt/" + k] = _host_tensor(v)
        return state, opt_json

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            if self.legacy_format:
                self.model.save(os.path.join(self.save_dir, f"{epoch}"))
            else:
                state, opt_json = self._capture()
                self._mgr().save(epoch, state=state,
                                 host_state={"epoch": epoch,
                                             "opt_json": opt_json})

    def on_train_end(self, logs=None):
        if self.save_dir:
            if self._manager is not None:
                self._manager.wait()
            self.model.save(os.path.join(self.save_dir, "final"))

    def restore_latest(self, model=None):
        """Load the newest intact epoch checkpoint into ``model`` (or the
        attached one).  Returns the epoch number, or None when the
        directory holds no committed checkpoint.  With
        ``legacy_format=True`` this loads the newest ``save_dir/{epoch}``
        ``Model.save`` files instead."""
        from ..dygraph.tensor import Tensor

        model = model or self.model
        if self.legacy_format:
            try:
                entries = os.listdir(self.save_dir)
            except OSError:
                return None
            epochs = sorted(int(e[:-len(".pdparams")]) for e in entries
                            if e.endswith(".pdparams")
                            and e[:-len(".pdparams")].isdigit())
            if not epochs:
                return None
            model.load(os.path.join(self.save_dir, str(epochs[-1])))
            return epochs[-1]
        meta = self._mgr().restore(device="cpu")
        if meta is None:
            return None
        state = meta["state"]
        model.network.set_state_dict(
            {k[len("param/"):]: Tensor(v) for k, v in state.items()
             if k.startswith("param/")})
        if getattr(model, "_static_mode", False) and model._st is not None:
            scope = model._st["scope"]
            for p in model.network.parameters():
                scope.set_var(p.name, p._value.detach().clone())
        opt = getattr(model, "_optimizer", None)
        od = {k[len("opt/"):]: v for k, v in state.items()
              if k.startswith("opt/")}
        od.update(meta["host_state"].get("opt_json") or {})
        if od and opt is not None and hasattr(opt, "set_state_dict"):
            opt.set_state_dict(od)
        return int(meta["host_state"].get("epoch", meta["step"]))


def _host_tensor(v):
    """A host copy of a dygraph Tensor, tensor or array value."""
    import numpy as np
    import torch

    t = getattr(v, "_value", v)
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    return np.array(v, copy=True)


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if hasattr(cur, "__len__"):
            cur = float(cur[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class BenchmarkCallback(Callback):
    """Step-telemetry callback (the hapi face of ``observe``).

    Times every train batch into the ``hapi_step_time_seconds``
    histogram (log-bucketed; p50/p95/p99) and reports a throughput + MFU
    summary at ``on_train_end``.  Works in both adapters: in static mode
    the Executor's own StepTimer supplies the FLOPs accounting (merged
    into ``summary()``); in dygraph mode pass ``flops_per_step=`` (e.g.
    ``model_stat.program_flops`` of the static train program) for an MFU
    number.  A step's time runs from ``on_train_batch_begin`` to
    ``on_train_batch_end``: the loader's wait for the batch is outside
    it.
    """

    HIST = "hapi_step_time_seconds"

    def __init__(self, batch_size=None, flops_per_step=None, log_freq=0,
                 peak_tflops=None):
        super().__init__()
        self.batch_size = batch_size
        self.flops_per_step = flops_per_step
        self.log_freq = int(log_freq)
        self.peak_tflops = peak_tflops
        self.last_summary = None
        self._t0 = None
        self._steps = 0
        self._time = 0.0

    def on_train_begin(self, logs=None):
        histogram(self.HIST).reset()
        self._steps = 0
        self._time = 0.0

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        stat_time(self.HIST, dt)
        self._steps += 1
        self._time += dt
        if self.log_freq and (step + 1) % self.log_freq == 0:
            s = histogram(self.HIST).summary()
            print(f"[bench] step {step + 1}: "
                  f"p50 {s.get('p50', 0) * 1e3:.2f}ms "
                  f"p95 {s.get('p95', 0) * 1e3:.2f}ms "
                  f"({self._steps / max(self._time, 1e-9):.1f} steps/s)")

    def summary(self):
        hist = histogram(self.HIST).summary()
        out = {"steps": self._steps, "step_time_s": hist}
        if self._steps and self._time > 0:
            out["steps_per_sec"] = round(self._steps / self._time, 3)
            if self.batch_size:
                out["examples_per_sec"] = round(
                    self.batch_size * self._steps / self._time, 3)
            if self.flops_per_step:
                from ..framework import flags as _flags

                peak = self.peak_tflops if self.peak_tflops is not None \
                    else float(_flags.flag("device_peak_tflops"))
                if peak > 0.0:
                    mfu = mfu_estimate(
                        self.flops_per_step, self._time / self._steps,
                        peak)
                    out["mfu"] = float(f"{mfu:.4g}")
                else:
                    # no peak configured: no denominator — null, not a
                    # misleading 0.0 (matches StepTimer.summary)
                    out["mfu"] = None
        if "mfu" not in out:
            # static adapter: the Executor's StepTimer priced the
            # program IR (hapi/model_stat.py): reuse its MFU
            exec_summary = step_timer().summary(self.peak_tflops)
            for k in ("mfu", "flops_per_step"):
                if k in exec_summary:
                    out[k] = exec_summary[k]
        return out

    def on_train_end(self, logs=None):
        self.last_summary = s = self.summary()
        if self._steps:
            parts = [f"steps {s['steps']}",
                     f"p50 {s['step_time_s'].get('p50', 0) * 1e3:.2f}ms",
                     f"p95 {s['step_time_s'].get('p95', 0) * 1e3:.2f}ms"]
            if "examples_per_sec" in s:
                parts.append(f"{s['examples_per_sec']:.1f} ex/s")
            if s.get("mfu") is not None:  # None = peak tflops unset
                parts.append(f"MFU {s['mfu']:.3f}")
            print("[bench] " + " - ".join(parts))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step, self.by_epoch = by_step, by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s:
            s.step()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose=2, log_freq=1, save_freq=1, save_dir=None,
                     metrics=None):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": metrics or []})
    return cl
