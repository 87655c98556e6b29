"""PyTorch port: static-graph BERT pretraining, end to end on the CPU.

A tiny BERT (batch 2, sequence 128, hidden 128, 2 heads, 2 layers, ffn
256, vocab 64, 3 predictions a sequence, dropout 0, AdamW at lr 1e-3, one
padded key in the attention mask) is built by both packages, started
from the JAX package's startup values (carried over with
``scope_from_numpy``: the packages draw random numbers differently) and
trained 3 steps by both executors on the same feeds.

Tolerances:
- float32: losses and final parameters within 1e-4 (absolute, on losses
  of about 3-5 and weights of about 0.02-1).  The two run the same float32
  arithmetic in other summation orders; the measured gap is about 1e-5.
- bfloat16 AMP: the matmuls, attention and their gradients run in
  bfloat16 (8 significant bits), rounded at places that differ between
  XLA and torch.  The losses are held to one bfloat16 rounding step,
  2**-8 relative.  A weight's AdamW step is about lr in size whatever the
  gradient's scale, so a gradient element whose rounding flips its sign
  moves the two packages' weights apart by up to 2 * lr a step:
  2 * 1e-3 * 3 steps = 6e-3 absolute.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpkg
from paddle_tpu.amp.static_amp import decorate as jdecorate
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.ops import fused as jfused
from paddle_tpu.text import bert_base_pretrain_program as jbert
import paddle_tpu_torch as tpkg
from paddle_tpu_torch.amp import decorate as tdecorate
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework import unique_name as tunique
from paddle_tpu_torch.framework.scope import scope_from_numpy
from paddle_tpu_torch.ops import flash_attention_bias as fab
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.text import bert_base_pretrain_program as tbert

B, S, V, P, STEPS, LR = 2, 128, 64, 3, 3, 1e-3
CFG = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=128, n_layers=2,
           n_heads=2, ffn_size=256, dropout_prob=0.0, lr=LR,
           max_preds_per_seq=P)
F32_TOL = 1e-4
BF16_LOSS_RTOL = 2.0 ** -8
BF16_PARAM_ATOL = 2 * LR * STEPS
PACKAGES = {"jax": (jbert, jdecorate, jprogram, junique),
            "torch": (tbert, tdecorate, tprogram, tunique)}


def _build(which, amp=False):
    bert, decorate, prog_mod, unique = PACKAGES[which]
    with unique.guard():
        main, startup, _feeds, loss, opt = bert(**CFG)
        main.random_seed = 1
        with prog_mod.program_guard(main, startup):
            (decorate(opt, use_bf16=True) if amp else opt).minimize(loss)
    return main, startup, loss


def _feed(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, (B, S)).astype("int64")
    flat_pos = np.concatenate([b * S + rs.choice(S, P, replace=False)
                               for b in range(B)]).astype("int64")
    mask = np.zeros((B, 1, 1, S), "float32")
    mask[1, 0, 0, -1] = -1e4        # one padded key
    return {"input_ids": ids,
            "token_type_ids": (rs.rand(B, S) < 0.5).astype("int64"),
            "pos_ids": np.tile(np.arange(S, dtype="int64"), (B, 1)),
            "input_mask": mask, "masked_flat_pos": flat_pos,
            "masked_labels": ids.reshape(-1)[flat_pos].reshape(-1, 1),
            "masked_weights": np.ones((B * P, 1), "float32"),
            "nsp_labels": rs.randint(0, 2, (B, 1)).astype("int64")}


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's startup values (one startup program serves both
    AMP settings: decorate() adds no persistable state for bf16)."""
    _main, startup, _loss = _build("jax")
    scope = jpkg.framework.Scope()
    jpkg.Executor(jpkg.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.asarray(scope.get_var(v.name))
            for v in startup.global_block.vars.values() if v.persistable}


class _flash:
    """B1 engaged in both packages (the JAX kernel in interpret mode,
    exactly as tests/test_pallas_attention.py engages it; the port's
    wrapper on CPU tensors runs its plain version), or off."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        mode = "always" if self.on else "never"
        jfused._FORCE_INTERPRET = tfused._FORCE_ENGAGE = self.on
        jflags.set_flags({"FLAGS_flash_attention": mode})
        tpkg.set_flags({"FLAGS_flash_attention": mode})

    def __exit__(self, *exc):
        jfused._FORCE_INTERPRET = tfused._FORCE_ENGAGE = False
        jflags.set_flags({"FLAGS_flash_attention": "auto"})
        tpkg.set_flags({"FLAGS_flash_attention": "auto"})


def _train_jax(init, amp, feed):
    main, _startup, loss = _build("jax", amp)
    scope = jpkg.framework.Scope()
    for n, a in init.items():
        scope.set_var(n, a)
    exe = jpkg.Executor(jpkg.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).ravel()[0])
              for _ in range(STEPS)]
    return losses, {n: np.asarray(scope.get_var(n)).astype("f4")
                    for n in init}


def _train_torch(init, amp, feed):
    main, _startup, loss = _build("torch", amp)
    scope = scope_from_numpy(init, device="cpu")
    exe = tpkg.Executor(tpkg.CPUPlace())
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].ravel()[0])
              for _ in range(STEPS)]
    return losses, {n: scope.get_var(n).float().numpy() for n in init}


@pytest.mark.parametrize("flash", [True, False], ids=["b1", "plain"])
def test_float32_training_matches_jax(jax_init, flash):
    feed = _feed()
    fab.reset_launch_count()
    with _flash(flash):
        want_loss, want_params = _train_jax(jax_init, False, feed)
        got_loss, got_params = _train_torch(jax_init, False, feed)
    np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=F32_TOL)
    assert got_loss[-1] < got_loss[0]
    for n, w in want_params.items():
        np.testing.assert_allclose(got_params[n], w, rtol=0, atol=F32_TOL,
                                   err_msg=n)
    assert fab.flash_attention_bias.launches == 0   # CPU tensors


def test_bfloat16_amp_training_matches_jax(jax_init):
    feed = _feed()
    with _flash(True):
        want_loss, want_params = _train_jax(jax_init, True, feed)
        got_loss, got_params = _train_torch(jax_init, True, feed)
    np.testing.assert_allclose(got_loss, want_loss, rtol=BF16_LOSS_RTOL,
                               atol=0)
    for n, w in want_params.items():
        np.testing.assert_allclose(got_params[n], w, rtol=0,
                                   atol=BF16_PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["steps_K", "leading_step_dim"])
def test_run_steps_equals_run_calls(jax_init, stacked):
    """``run_steps`` in both feed modes gives what K ``run`` calls give,
    fetches stacked on a leading K dim, and leaves the scope where the
    calls leave it.  The same ops run in the same order, but the
    embedding gradient's scatter-add sums in a thread-dependent order on
    the CPU, so float32 rounding (1e-6 on values below 5) is allowed."""
    main, _startup, loss = _build("torch")
    exe = tpkg.Executor(tpkg.CPUPlace())
    feeds = [_feed(i if stacked else 0) for i in range(STEPS)]
    ref_scope = scope_from_numpy(jax_init, device="cpu")
    want = np.stack([exe.run(main, feed=f, fetch_list=[loss],
                             scope=ref_scope)[0] for f in feeds])
    scope = scope_from_numpy(jax_init, device="cpu")
    if stacked:
        feed = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
        out = exe.run_steps(main, feed=feed, fetch_list=[loss], scope=scope)
    else:
        out = exe.run_steps(main, feed=feeds[0], fetch_list=[loss],
                            scope=scope, steps=STEPS)
    assert isinstance(out[0], torch.Tensor)
    assert tuple(out[0].shape) == (STEPS,) + want.shape[1:]
    np.testing.assert_allclose(out[0].numpy(), want, rtol=0, atol=1e-6)
    for n in jax_init:
        np.testing.assert_allclose(scope.get_var(n).numpy(),
                                   ref_scope.get_var(n).numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


def test_missing_startup_names_the_op():
    main, _startup, loss = _build("torch")
    exe = tpkg.Executor(tpkg.CPUPlace())
    with pytest.raises(RuntimeError) as e:
        exe.run(main, feed=_feed(), fetch_list=[loss],
                scope=tpkg.framework.Scope())
    msg = str(e.value)
    assert "Did you run the startup program?" in msg
    assert "'lookup_table_v2' reads 'word_embedding'" in msg
    assert "test_torch_bert.py" in msg     # where the op was built


def test_port_startup_initializes_every_state_var():
    """The port's own startup program (torch draws) gives every
    persistable the JAX package's shape and type, with the initializers'
    statistics; a step from it gives a finite loss."""
    main, startup, loss = _build("torch")
    scope = tpkg.framework.Scope()
    exe = tpkg.Executor(tpkg.CPUPlace())
    exe.run(startup, scope=scope)
    _jmain, jstart, _jloss = _build("jax")
    for v in jstart.global_block.vars.values():
        if v.persistable:
            t = scope.get_var(v.name)
            assert tuple(t.shape) == tuple(v.shape), v.name
            assert t.dtype == tpkg.framework.dtypes.to_torch(v.dtype), v.name
    w = scope.get_var("word_embedding")
    assert abs(float(w.std()) - 0.02) < 0.002
    # the reference's scope API reads and writes the same tensors
    np.testing.assert_array_equal(
        np.asarray(scope.find_var("word_embedding").get_tensor()), w.numpy())
    assert scope.find_var("no_such_var") is None
    scope.var("extra").get_tensor().set(np.ones(3, "f4"))
    assert scope.get_var("extra").dtype == torch.float32
    out = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)[0]
    assert np.isfinite(out).all()


def test_fetch_of_an_unknown_var_names_it():
    main, startup, _loss = _build("torch")
    scope = tpkg.framework.Scope()
    exe = tpkg.Executor(tpkg.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(KeyError, match="no_such_var"):
        exe.run(main, feed=_feed(), fetch_list=["no_such_var"], scope=scope)
