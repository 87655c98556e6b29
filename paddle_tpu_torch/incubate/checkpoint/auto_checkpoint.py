"""Auto-checkpoint: periodic save from Executor.run with deterministic
resume.

Counterpart of ``paddle_tpu/incubate/checkpoint/auto_checkpoint.py``
(reference fluid/incubate/checkpoint/auto_checkpoint.py:71,
`AutoCheckpointChecker`, `train_epoch_range`, the `_auto_checkpoint`
hook in Executor.run at executor.py:1200).  Checkpoints ride
:class:`paddle_tpu_torch.ckpt.CheckpointManager` — the save is asynchronous
(training continues while the writer thread serializes), commits are
atomic with a SHA-256 manifest, old snapshots are retention-GC'd, and
resume restores the FULL scope (parameters, optimizer slots, AMP
loss-scale counters, the generator) plus the epoch/step counters, so a
restarted job is bitwise a continuation of the crashed one; restored
values land on the executor's device.  Rank 0 (``parallel_env.get_rank``:
the live group's rank, else ``PADDLE_TRAINER_ID``) writes, through a
one-rank manager: against ZeRO-1 sharded state the save raises, as in
the JAX package, pointing to ``distributed.checkpoint.save_sharded``.

Enable via env (reference contract) or explicitly::

    PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT \
    PADDLE_EDL_HDFS_CHECKPOINT_PATH=/ckpt/dir  python train.py

    # or
    auto_checkpoint.configure(dir, save_interval_s=10)
    for epoch in auto_checkpoint.train_epoch_range("job1", 10):
        exe.run(...)   # saves on the configured cadence, resumes on boot
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

_cfg = None


class _Config:
    def __init__(self, dirname, save_interval_s=10.0, every_n_steps=None,
                 async_save=None, keep_n=None):
        self.dirname = dirname
        self.save_interval_s = save_interval_s
        self.every_n_steps = every_n_steps
        self.async_save = async_save
        self.keep_n = keep_n
        self.last_save = 0.0
        self.step = 0
        self.epoch_state = {}
        self.resume_attempted = False
        self.manager = None


def _env_config() -> Optional[_Config]:
    if os.environ.get("PADDLE_RUNNING_ENV") != "PADDLE_EDL_AUTO_CHECKPOINT":
        return None
    path = os.environ.get("PADDLE_EDL_HDFS_CHECKPOINT_PATH")
    if not path:
        return None
    interval = float(os.environ.get("PADDLE_EDL_SAVE_CHECKPOINT_INTER", "10"))
    return _Config(path, save_interval_s=interval)


def configure(dirname, save_interval_s=10.0, every_n_steps=None,
              async_save=None, keep_n=None):
    """Programmatic enable (tests / single scripts).  ``async_save`` /
    ``keep_n`` default from ``FLAGS_ckpt_async_save`` /
    ``FLAGS_ckpt_keep_n``."""
    global _cfg
    _cfg = _Config(dirname, save_interval_s, every_n_steps,
                   async_save=async_save, keep_n=keep_n)
    return _cfg


def disable():
    # detach FIRST: close() re-raises a failed background save, and a
    # config left active with a closed manager would crash every
    # subsequent Executor.run instead of having auto-checkpoint off
    global _cfg
    cfg, _cfg = _cfg, None
    if cfg is not None and cfg.manager is not None:
        cfg.manager.close()


def _active() -> Optional[_Config]:
    global _cfg
    if _cfg is None:
        _cfg = _env_config()
    return _cfg


def _is_rank0() -> bool:
    # the live group's rank, else PADDLE_TRAINER_ID: treating every
    # process of a job as rank 0 would race them all on one step_<N>.tmp
    from ...distributed.parallel_env import get_rank

    return get_rank() == 0


def _ckpt_dir(cfg):
    return os.path.join(cfg.dirname, "auto_ckpt")


def _manager(cfg):
    if cfg.manager is None:
        from ...ckpt import CheckpointManager

        # only rank 0 ever saves (the on_executor_run gate): the
        # snapshot is rank-0-local
        cfg.manager = CheckpointManager(
            _ckpt_dir(cfg), keep_n=cfg.keep_n, async_save=cfg.async_save,
            rank=0, world_size=1)
    return cfg.manager


def wait(cfg=None):
    """Drain the pending async save (test/shutdown barrier)."""
    cfg = cfg or _active()
    if cfg is not None and cfg.manager is not None:
        cfg.manager.wait()


def save_checkpoint(exe, program, scope, cfg=None):
    """Snapshot the FULL scope + counters through the manager (the
    reference save_checkpoint saved persistables only)."""
    from ...framework.scope import global_scope

    cfg = cfg or _active()
    scope = scope or global_scope()
    _manager(cfg).save(cfg.step, scope=scope,
                       host_state={"epoch_state": cfg.epoch_state,
                                   "time": time.time()})


def load_checkpoint(exe, program, scope, cfg=None) -> Optional[dict]:
    """Restore the newest intact snapshot; returns a meta dict with
    ``step``/``epoch_state`` or None when nothing was ever committed."""
    from ...framework.scope import global_scope

    cfg = cfg or _active()
    scope = scope or global_scope()
    if not os.path.isdir(_ckpt_dir(cfg)):
        return None
    meta = _manager(cfg).restore(
        scope=scope, device=exe.device if exe is not None else None)
    if meta is None:
        return None
    host = meta.get("host_state", {}) or {}
    cfg.step = int(meta["step"])
    cfg.epoch_state = dict(host.get("epoch_state", {}))
    return {"step": cfg.step, "epoch_state": cfg.epoch_state,
            "time": host.get("time")}


def on_executor_run(exe, program, scope, fed=True):
    """The Executor.run hook (reference executor.py:1200): counts steps
    and saves on the configured cadence from rank 0.  Only fed runs count
    as steps — startup/init programs carry no feeds."""
    cfg = _active()
    if cfg is None or not _is_rank0() or not fed:
        return
    cfg.step += 1
    due = False
    if cfg.every_n_steps:
        due = cfg.step % cfg.every_n_steps == 0
    else:
        due = (time.time() - cfg.last_save) >= cfg.save_interval_s
    if due:
        save_checkpoint(exe, program, scope, cfg)
        cfg.last_save = time.time()


def maybe_resume(exe, program, scope, fed=True):
    """Pre-run hook: on a restarted job, restore the previous snapshot
    BEFORE the first counted step executes (the env-mode resume contract;
    reference AutoCheckpointChecker restores epoch ranges the same way)."""
    cfg = _active()
    if cfg is None or not fed or cfg.resume_attempted:
        return
    cfg.resume_attempted = True
    load_checkpoint(exe, program, scope, cfg)


def _peek_epoch_state(cfg) -> None:
    """Before a restarted job's first fed run (``maybe_resume`` restores
    the state there), take the epoch counters of the newest intact
    checkpoint, so ``train_epoch_range`` skips the finished epochs from
    its first iteration; the JAX package reads them only at that
    restore."""
    if not os.path.isdir(_ckpt_dir(cfg)):
        return
    m = _manager(cfg)
    step = m.latest_intact_step()
    if step is None:
        return
    with open(os.path.join(m._step_dir(step), "meta_r0.json")) as f:
        host = json.load(f).get("host_state", {}) or {}
    cfg.epoch_state = dict(host.get("epoch_state", {}))


class train_epoch_range:
    """Reference `acp.train_epoch_range(name, max_epoch)`: iterate epochs,
    skipping the ones a restored checkpoint already finished."""

    def __init__(self, name, max_epoch_num):
        self.name = name
        self.max = max_epoch_num

    def __iter__(self):
        cfg = _active()
        start = 0
        if cfg is not None:
            if not cfg.resume_attempted:
                _peek_epoch_state(cfg)
            start = int(cfg.epoch_state.get(self.name, 0))
        for e in range(start, self.max):
            yield e
            if cfg is not None:
                cfg.epoch_state[self.name] = e + 1
