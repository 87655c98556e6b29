"""PyTorch port: resuming from checkpoints (``paddle_tpu_torch.ckpt``,
``distributed.checkpoint``, ``hapi.callbacks.ModelCheckpoint``), held to
the JAX package's single-process oracles (``tests/test_ckpt.py``,
``tests/test_pipelined_dispatch.py``).

Every comparison is exact: a resumed run is a continuation of the
uninterrupted one, bit for bit, in losses and in the final state
(parameters, momentum slots, the LR scheduler's step, the generator,
the dynamic loss scale's counters, the data iterator's position).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import layers
from paddle_tpu_torch.ckpt import (CheckpointError, CheckpointManager,
                                   ResumableIterator, restore_scope,
                                   snapshot_scope)
from paddle_tpu_torch.framework import unique_name
from paddle_tpu_torch.framework.program import Program, program_guard
from paddle_tpu_torch.framework.scope import (Scope, _switch_scope,
                                              global_scope)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y.cpu()), k
        else:   # a GeneratorState
            assert torch.equal(x.state, y.state), k


def _build_full_model():
    """fc -> dropout (draws from the generator) -> fc, MSE, Momentum
    under StepDecay and float16 dynamic loss scaling."""
    from paddle_tpu_torch.amp.static_amp import decorate
    from paddle_tpu_torch.optimizer import MomentumOptimizer
    from paddle_tpu_torch.optimizer_lr import StepDecay

    main, startup = Program(), Program()
    main.random_seed = 3
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", [8])
        y = layers.data("y", [1])
        h = layers.fc(x, 16, act="relu", bias_attr=False)
        h = layers.dropout(h, 0.3)
        pred = layers.fc(h, 1, bias_attr=False)
        loss = layers.mean(layers.square_error_cost(pred, y))
        sched = StepDecay(0.1, step_size=2, gamma=0.5)
        opt = MomentumOptimizer(sched, 0.9)
        amp = decorate(opt, use_bf16=False, init_loss_scaling=2.0 ** 4,
                       incr_every_n_steps=2, use_dynamic_loss_scaling=True)
        amp.minimize(loss)
    return main, startup, loss, sched


def _make_iter():
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    rs = np.random.RandomState(0)
    X = rs.randn(32, 8).astype("f4")
    Y = (X.sum(1, keepdims=True) * 0.3).astype("f4")
    return ResumableIterator(DataLoader(TensorDataset([X, Y]),
                                        batch_size=8, shuffle=False))


def _run_training(ckpt_dir, steps, manager=None, crash_at=None,
                  resume=False):
    """One 'process': fresh programs, scope, scheduler and iterator; an
    optional restore; an async save after every step; returns (losses,
    final state, manager)."""
    main, startup, loss, sched = _build_full_model()
    exe = pt.Executor(pt.CPUPlace())
    old = _switch_scope(Scope())
    try:
        exe.run(startup)
        it = _make_iter()
        m = manager or CheckpointManager(ckpt_dir, keep_n=0,
                                         async_save=True)
        m.register("lr_sched", sched)
        m.register("data", it)
        start = 0
        if resume:
            meta = m.restore(scope=global_scope(), device="cpu")
            assert meta is not None
            start = meta["step"]
        if crash_at is not None:
            def hook(phase, step):
                if phase == "pre_commit" and step == crash_at:
                    raise RuntimeError("injected mid-save crash")

            m.set_fault_hook(hook)
        handles = []
        for step in range(start + 1, steps + 1):
            bx, by = next(it)
            handles.append(exe.run(main, feed={"x": bx, "y": by},
                                   fetch_list=[loss]))
            sched.step()
            m.save(step, scope=global_scope())
            if crash_at is not None and step < crash_at:
                m.wait()
        if crash_at is None:
            m.wait()
        else:
            with pytest.raises(CheckpointError, match="injected"):
                m.wait()
        losses = [float(h[0].ravel()[0]) for h in handles]
        return losses, snapshot_scope(global_scope()), m
    finally:
        _switch_scope(old)


def test_async_crash_resume_bitwise_parity(tmp_path):
    """A crash during the async save of step 4 leaves step_4.tmp and
    intact step 3; a fresh executor and scope restore 3 and run 4..7:
    losses and final state bit-equal to the uninterrupted run."""
    oracle, crashy = str(tmp_path / "oracle"), str(tmp_path / "crashy")
    full_losses, full_state, mo = _run_training(oracle, steps=7)
    mo.close()
    b_losses, _, mb = _run_training(crashy, steps=4, crash_at=4)
    mb.set_fault_hook(None)
    mb.close()
    assert os.path.isdir(os.path.join(crashy, "step_4.tmp"))
    assert CheckpointManager(crashy).latest_intact_step() == 3
    c_losses, c_state, mc = _run_training(crashy, steps=7, resume=True)
    mc.close()
    assert b_losses == full_losses[:4]
    assert c_losses == full_losses[3:]
    _same(c_state, full_state)


def test_async_vs_sync_and_loss_scale_lr_state(tmp_path):
    """Async and sync checkpoints of one run are bit-equal; the dynamic
    loss scale (doubled twice in 4 steps), the LR var (halved twice),
    the good-steps counter and the generator are in the checkpoint."""
    a_losses, _, ma = _run_training(str(tmp_path / "a"), steps=4)
    ma.close()
    sync_mgr = CheckpointManager(str(tmp_path / "b"), keep_n=0,
                                 async_save=False)
    b_losses, _, mb = _run_training(str(tmp_path / "b"), steps=4,
                                    manager=sync_mgr)
    mb.close()
    assert a_losses == b_losses
    sa = CheckpointManager(str(tmp_path / "a")).restore(
        step=4, device="cpu")["state"]
    sb = CheckpointManager(str(tmp_path / "b")).restore(
        step=4, device="cpu")["state"]
    assert sorted(sa) == sorted(sb)
    for n in sa:
        if isinstance(sa[n], torch.Tensor):
            assert torch.equal(sa[n], sb[n]), n
    names = sorted(sa)
    ls = [n for n in names if "loss_scaling" in n]
    lr = [n for n in names if n.startswith("learning_rate")]
    good = [n for n in names if "good_steps" in n]
    assert ls and lr and good, names
    assert float(sa[ls[0]].reshape(-1)[0]) == 2.0 ** 6
    np.testing.assert_allclose(float(sa[lr[0]].reshape(-1)[0]),
                               0.1 * 0.5 ** 2)
    assert isinstance(sa["@RNG_KEY@"], torch.Generator)


def test_snapshot_mid_pipeline_drains_and_matches_sync(tmp_path):
    """A save while steps are in flight drains the window first and
    commits bit-equal the state a synchronous run has at that step;
    resuming from it continues bit-equal."""
    from paddle_tpu_torch.optimizer import MomentumOptimizer

    def model():
        main, startup = Program(), Program()
        main.random_seed = 3
        with unique_name.guard(), program_guard(main, startup):
            x = layers.data("x", [8])
            y = layers.data("y", [1])
            h = layers.dropout(layers.fc(x, 16, act="relu"), 0.3)
            loss = layers.mean(layers.square_error_cost(
                layers.fc(h, 1), y))
            MomentumOptimizer(0.05, 0.9).minimize(loss)
        return main, startup, loss

    rs = np.random.RandomState(0)
    batches = [(rs.randn(16, 8).astype("f4"), rs.randn(16, 1).astype("f4"))
               for _ in range(5)]
    try:
        pt.set_flags({"FLAGS_max_inflight_steps": 0})
        main, startup, loss = model()
        exe = pt.Executor(pt.CPUPlace())
        sc = Scope()
        exe.run(startup, scope=sc)
        sync_losses, state3 = [], None
        for i, (bx, by) in enumerate(batches, 1):
            o = exe.run(main, feed={"x": bx, "y": by}, fetch_list=[loss],
                        scope=sc)
            sync_losses.append(float(o[0].ravel()[0]))
            if i == 3:
                state3 = snapshot_scope(sc)
        pt.set_flags({"FLAGS_max_inflight_steps": 2})
        main2, startup2, loss2 = model()
        exe2 = pt.Executor(pt.CPUPlace())
        sc2 = Scope()
        exe2.run(startup2, scope=sc2)
        handles = [exe2.run(main2, feed={"x": bx, "y": by},
                            fetch_list=[loss2], scope=sc2)
                   for bx, by in batches[:3]]
        assert len(exe2._window) > 0
        m = CheckpointManager(str(tmp_path), keep_n=0, async_save=True)
        m.save(3, scope=sc2, wait=True)
        assert len(exe2._window) == 0
        assert [float(h[0].ravel()[0]) for h in handles] == \
            sync_losses[:3]
        meta = m.restore(device="cpu")
        assert meta["step"] == 3
        got = {n: (v if isinstance(v, torch.Tensor) else None)
               for n, v in meta["state"].items()}
        for n, v in state3.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[n], v), n
        main3, startup3, loss3 = model()
        exe3 = pt.Executor(pt.CPUPlace())
        sc3 = Scope()
        exe3.run(startup3, scope=sc3)
        restore_scope(sc3, state3, device="cpu")
        resumed = [float(exe3.run(main3, feed={"x": bx, "y": by},
                                  fetch_list=[loss3], scope=sc3)[0]
                         .ravel()[0]) for bx, by in batches[3:]]
        assert resumed == sync_losses[3:]
        m.close()
    finally:
        pt.set_flags({"FLAGS_max_inflight_steps": 2})


def _fit_model(sched=None):
    import paddle_tpu_torch.nn as nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 1)

        def forward(self, x):
            return self.fc(x)

    pt.seed(1)
    model = pt.Model(Net())
    model.prepare(optimizer=pt.optimizer.Adam(
        sched if sched is not None else 0.01,
        parameters=model.parameters()), loss=nn.MSELoss())
    return model


def _loader(n):
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    rs = np.random.RandomState(0)
    X = rs.randn(n, 4).astype("f4")
    Y = (X.sum(1, keepdims=True) * 0.5).astype("f4")
    return DataLoader(TensorDataset([X, Y]), batch_size=8, shuffle=False)


@pytest.fixture
def cpu():
    pt.set_device("cpu")
    yield
    pt.set_device("gpu:0") if torch.cuda.is_available() else None


def test_model_checkpoint_async_retention(tmp_path, cpu):
    from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint

    class DrainedCheckpoint(ModelCheckpoint):
        """Commit every epoch (a fast fit() loop coalesces otherwise)."""

        def on_epoch_end(self, epoch, logs=None):
            super().on_epoch_end(epoch, logs)
            if self._manager is not None:
                self._manager.wait()

    model = _fit_model()
    cb = DrainedCheckpoint(save_freq=1, save_dir=str(tmp_path), keep_n=2,
                           async_save=True)
    model.fit(_loader(16), epochs=4, verbose=0, callbacks=[cb])
    kept = cb._manager.all_steps()
    assert kept == [2, 3]
    for s in kept:
        assert (tmp_path / f"step_{s}" / "MANIFEST.json").is_file()
    assert (tmp_path / "final.pdparams").is_file()
    trained = {k: v.numpy().copy()
               for k, v in model.network.state_dict().items()}
    fresh = _fit_model()
    assert cb.restore_latest(fresh) == 3
    for k, v in fresh.network.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), trained[k])
    cb._manager.close()


def test_model_checkpoint_legacy_format_and_lr_scheduler(tmp_path, cpu):
    """legacy_format=True keeps save_dir/{epoch} Model.save files and
    never engages the manager; the default route carries the LR
    scheduler's state in its JSON host state."""
    from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint
    from paddle_tpu_torch.optimizer_lr import StepDecay

    model = _fit_model()
    cb = ModelCheckpoint(save_freq=1, save_dir=str(tmp_path / "legacy"),
                         legacy_format=True)
    model.fit(_loader(8), epochs=2, verbose=0, callbacks=[cb])
    for f in ("0.pdparams", "1.pdparams", "final.pdparams"):
        assert (tmp_path / "legacy" / f).is_file()
    assert cb._manager is None
    assert cb.restore_latest(_fit_model()) == 1

    sched = StepDecay(0.1, step_size=2)
    model = _fit_model(sched)
    sched.step(), sched.step(), sched.step()
    saved_state = sched.state_dict()
    cb = ModelCheckpoint(save_freq=1, save_dir=str(tmp_path / "lr"),
                         async_save=False)
    model.fit(_loader(8), epochs=1, verbose=0, callbacks=[cb])
    fresh_sched = StepDecay(0.1, step_size=2)
    fresh = _fit_model(fresh_sched)
    assert fresh_sched.state_dict() != saved_state
    cb.restore_latest(fresh)
    assert fresh_sched.state_dict() == saved_state
    cb._manager.close()


def test_save_sharded_and_load_sharded_at_world_size_1(tmp_path):
    from paddle_tpu_torch.distributed import checkpoint as dckpt

    sc = Scope()
    sc.set_var("w", np.arange(6, dtype="f4").reshape(2, 3))
    assert dckpt.save_sharded(sc, str(tmp_path), step=42) == ["w"]
    m = dckpt._MANAGERS[os.path.abspath(str(tmp_path))]
    sc.set_var("w", np.ones((2, 3), "f4"))
    dckpt.save_sharded(sc, str(tmp_path))
    assert m.all_steps() == [42, 43]
    assert dckpt._MANAGERS[os.path.abspath(str(tmp_path))] is m
    out = Scope()
    assert dckpt.load_sharded(out, str(tmp_path), device="cpu") == ["w"]
    assert torch.equal(out.get_var("w"), torch.ones(2, 3))
    with pytest.raises(CheckpointError, match="does not exist"):
        dckpt.load_sharded(out, str(tmp_path / "nope"), device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(CheckpointError, match="no committed checkpoint"):
        dckpt.load_sharded(out, str(tmp_path / "empty"), device="cpu")
