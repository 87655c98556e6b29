"""PyTorch port: auto-checkpoint (``incubate.checkpoint.auto_checkpoint``,
hooked into ``Executor.run``), ``paddle.save``/``paddle.load``, and a
resume in a fresh process, held to the JAX package
(``tests/test_auto_checkpoint.py``, ``tests/test_checkpoint_io.py``).

Resumed runs are held bit-equal to uninterrupted ones (the JAX package
holds its own to 1e-5); files cross between the packages bit-equal.
"""
import collections
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jpkg
from paddle_tpu import layers as jlayers
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.framework.program import Program as JProgram
from paddle_tpu.framework.program import program_guard as jguard
import paddle_tpu_torch as pt
from paddle_tpu_torch import layers
from paddle_tpu_torch.ckpt import CheckpointError
from paddle_tpu_torch.framework import unique_name
from paddle_tpu_torch.framework.program import Program, program_guard
from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as acp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build():
    from paddle_tpu_torch.optimizer import MomentumOptimizer

    main, startup = Program(), Program()
    main.random_seed = 1
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", [4])
        y = layers.data("y", [1])
        h = layers.dropout(layers.fc(x, 8, act="relu"), 0.2)
        pred = layers.fc(h, 1, bias_attr=False)
        loss = layers.mean(layers.square_error_cost(pred, y))
        MomentumOptimizer(0.05, 0.9).minimize(loss)
    return main, startup, loss


def _feed():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(8, 4).astype("f4"),
            "y": rs.randn(8, 1).astype("f4")}


def _losses(exe, main, loss, scope, n):
    hs = [exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
          for _ in range(n)]
    return [float(h[0].ravel()[0]) for h in hs]


def _fresh():
    main, startup, loss = _build()
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.framework.Scope()
    exe.run(startup, scope=scope)
    return exe, main, loss, scope


def test_auto_checkpoint_saves_and_resumes(tmp_path):
    """Run A saves every 2 fed steps (5 steps: the last commit is step
    4); run B, a fresh executor and scope, restores step 4 and runs 2
    steps, bit-equal to steps 5-6 of an uninterrupted run."""
    acp.configure(str(tmp_path), every_n_steps=2)
    try:
        exe, main, loss, scope = _fresh()
        _losses(exe, main, loss, scope, 5)
        acp.wait()
        assert (tmp_path / "auto_ckpt" / "step_4" / "MANIFEST.json").is_file()
    finally:
        acp.disable()
    acp.configure(str(tmp_path), every_n_steps=2)
    try:
        exe2, main2, loss2, scope2 = _fresh()
        meta = acp.load_checkpoint(exe2, main2, scope2)
        assert meta is not None and meta["step"] == 4
        resumed = _losses(exe2, main2, loss2, scope2, 2)
    finally:
        acp.disable()
    exe3, main3, loss3, scope3 = _fresh()
    full = _losses(exe3, main3, loss3, scope3, 7)
    assert resumed == full[4:6]


def test_the_environment_route_resumes_before_the_first_fed_run(
        tmp_path, monkeypatch):
    """PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT with a checkpoint
    path (a local directory) and a 0 s interval: every fed run saves;
    a fresh executor's first fed run restores the newest step first and
    continues bit-equal."""
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    monkeypatch.setenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("PADDLE_EDL_SAVE_CHECKPOINT_INTER", "0")
    try:
        exe, main, loss, scope = _fresh()
        _losses(exe, main, loss, scope, 3)
        acp.wait()
        assert acp._cfg.manager.all_steps()[-1] == 3
    finally:
        acp.disable()
    try:
        exe2, main2, loss2, scope2 = _fresh()
        resumed = _losses(exe2, main2, loss2, scope2, 2)
        assert acp._cfg.step == 5
        acp.wait()
    finally:
        acp.disable()
    monkeypatch.delenv("PADDLE_RUNNING_ENV")
    exe3, main3, loss3, scope3 = _fresh()
    assert resumed == _losses(exe3, main3, loss3, scope3, 5)[3:]


def test_train_epoch_range_skips_finished_epochs(tmp_path):
    acp.configure(str(tmp_path), every_n_steps=1000)
    try:
        seen = []
        for e in acp.train_epoch_range("job", 4):
            seen.append(e)
            if e == 1:
                break
        assert seen == [0, 1]
        assert list(acp.train_epoch_range("job", 4)) == [1, 2, 3]
    finally:
        acp.disable()


def test_a_restarted_job_skips_the_epochs_its_checkpoint_finished(
        tmp_path):
    """Two epochs of 2 fed steps, a save every 2: the checkpoint of step
    4 holds epoch 0 done.  A restarted job's train_epoch_range starts at
    epoch 1 before any run; its first fed run restores step 4."""
    acp.configure(str(tmp_path), every_n_steps=2)
    try:
        exe, main, loss, scope = _fresh()
        for epoch in acp.train_epoch_range("job", 3):
            _losses(exe, main, loss, scope, 2)
            if epoch == 1:
                break
        acp.wait()
    finally:
        acp.disable()
    acp.configure(str(tmp_path), every_n_steps=2)
    try:
        exe2, main2, loss2, scope2 = _fresh()
        it = iter(acp.train_epoch_range("job", 3))
        assert next(it) == 1
        _losses(exe2, main2, loss2, scope2, 1)
        assert acp._cfg.step == 5
    finally:
        acp.disable()


def test_disable_detaches_even_when_drain_fails(tmp_path, monkeypatch):
    cfg = acp.configure(str(tmp_path))
    m = acp._manager(cfg)
    assert m.rank == 0 and m.world_size == 1

    class _FailingManager:
        def close(self):
            raise CheckpointError("background save failed")

    m.close()
    cfg.manager = _FailingManager()
    with pytest.raises(CheckpointError):
        acp.disable()
    assert acp._cfg is None
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    assert not acp._is_rank0()
    monkeypatch.delenv("PADDLE_TRAINER_ID")
    assert acp._is_rank0()


def _jax_program():
    main, startup = JProgram(), JProgram()
    with junique.guard(), jguard(main, startup):
        x = jlayers.data("x", [4])
        jlayers.fc(x, 3, act="relu")
    return main


def _port_program():
    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", [4])
        layers.fc(x, 3, act="relu")
    return main


Pair = collections.namedtuple("Pair", ["w", "b"])


def test_save_and_load_cross_between_the_packages(tmp_path):
    """A state dict, a namedtuple and a Program saved by the port load in
    the JAX package, and the JAX package's load in the port, bit-equal;
    the port's load places arrays on the asked device."""
    rs = np.random.RandomState(2)
    sd = {"w": rs.randn(3, 4).astype("f4"), "n": np.arange(5),
          "nested": [rs.randn(2).astype("f4"), {"k": np.int64(7)}]}
    pair = Pair(rs.randn(2, 2).astype("f4"), rs.randn(2).astype("f4"))
    pt.save({k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in sd.items()}, str(tmp_path / "t.pdparams"))
    pt.save(pair, str(tmp_path / "t.pair"))
    pt.save(_port_program(), str(tmp_path / "t.prog"))
    got = jpkg.load(str(tmp_path / "t.pdparams"))
    np.testing.assert_array_equal(got["w"], sd["w"])
    np.testing.assert_array_equal(got["n"], sd["n"])
    jpair = jpkg.load(str(tmp_path / "t.pair"))
    np.testing.assert_array_equal(jpair[0], pair.w)
    jprog = jpkg.load(str(tmp_path / "t.prog"))
    assert [op.type for op in jprog.global_block.ops] == \
        [op.type for op in _port_program().global_block.ops]

    jpkg.save(sd, str(tmp_path / "j.pdparams"))
    jpkg.save(pair, str(tmp_path / "j.pair"))
    jpkg.save(_jax_program(), str(tmp_path / "j.prog"))
    back = pt.load(str(tmp_path / "j.pdparams"), device="cpu")
    assert torch.equal(back["w"], torch.from_numpy(sd["w"]))
    assert back["n"].dtype == torch.int64
    assert torch.equal(back["nested"][0], torch.from_numpy(sd["nested"][0]))
    tpair = pt.load(str(tmp_path / "j.pair"), device="cpu")
    assert type(tpair).__name__ == "Pair"
    assert torch.equal(tpair.b, torch.from_numpy(pair.b))
    tprog = pt.load(str(tmp_path / "j.prog"), device="cpu")
    assert tprog.fingerprint() == _port_program().fingerprint()
    with pytest.raises(ValueError, match="bad magic"):
        (tmp_path / "junk").write_bytes(b"notafile")
        pt.load(str(tmp_path / "junk"), device="cpu")


def test_save_and_load_bf16_without_ml_dtypes(tmp_path, monkeypatch):
    """A bfloat16 tensor saves as its bits under the JAX package's dtype
    string and loads back bit-equal with ml_dtypes blocked."""
    monkeypatch.delitem(sys.modules, "ml_dtypes", raising=False)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    t = torch.randn(4, 3).to(torch.bfloat16)
    pt.save({"h": t, "f": t.float()}, str(tmp_path / "bf.pd"))
    back = pt.load(str(tmp_path / "bf.pd"), device="cpu")
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"], t)
    assert torch.equal(back["f"], t.float())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.load(str(tmp_path / "bf.pd"))


_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.ckpt import CheckpointManager
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.program import Program, program_guard
    from paddle_tpu_torch.optimizer import MomentumOptimizer

    phase, ckpt = sys.argv[1], sys.argv[2]
    main, startup = Program(), Program()
    main.random_seed = 1
    with unique_name.guard(), program_guard(main, startup):
        x = layers.data("x", [4])
        y = layers.data("y", [1])
        h = layers.dropout(layers.fc(x, 8, act="relu"), 0.2)
        loss = layers.mean(layers.square_error_cost(
            layers.fc(h, 1, bias_attr=False), y))
        MomentumOptimizer(0.05, 0.9).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    sc = pt.framework.Scope()
    exe.run(startup, scope=sc)
    m = CheckpointManager(ckpt, async_save=True)
    start = 0
    if phase == "resume":
        start = m.restore(scope=sc, device="cpu")["step"]
    rs = np.random.RandomState(0)
    feeds = [{{"x": rs.randn(8, 4).astype("f4"),
               "y": rs.randn(8, 1).astype("f4")}} for _ in range(7)]
    stop = 4 if phase == "train" else 7
    hs = [exe.run(main, feed=feeds[i], fetch_list=[loss], scope=sc)
          for i in range(start, stop)]
    if phase == "train":
        m.save(stop, scope=sc)
    print("LOSSES:" + ",".join(repr(float(h[0].ravel()[0])) for h in hs))
""").format(repo=REPO)


def test_resume_in_a_fresh_process(tmp_path):
    """A process trains 4 steps (dropout on), saves asynchronously and
    exits (the interpreter's exit drains the save); a new process
    restores and runs to step 7; a third runs all 7.  Losses of steps
    5-7 are bit-equal."""
    script = tmp_path / "resume.py"
    script.write_text(_SCRIPT)
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")

    def run(phase, d):
        out = subprocess.run([sys.executable, str(script), phase, d],
                             capture_output=True, text=True, timeout=240,
                             env=env)
        assert out.returncode == 0, out.stderr[-2000:]
        line = next(ln for ln in out.stdout.splitlines()
                    if ln.startswith("LOSSES:"))
        return [float(v) for v in line[len("LOSSES:"):].split(",")]

    first = run("train", ckpt)
    assert os.path.isdir(os.path.join(ckpt, "step_4"))
    resumed = run("resume", ckpt)
    full = run("full", str(tmp_path / "other"))
    assert first == full[:4]
    assert resumed == full[4:]
