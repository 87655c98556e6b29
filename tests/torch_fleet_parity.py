"""Shared harness of the fleet slice's parity tests: a program built the
same way in both packages (``paddle_tpu`` at world size 1 on a one-device
mesh), run on the CPU from the JAX startup's values.

- ``build_both(fn)``: ``fn(p)`` (``p`` is either package) builds and
  returns (main, startup, fetches...); each package's ``unique_name`` is
  guarded so both get the same var names.
- ``run_both(jax_parts, port_parts, feeds, fetch_names)``: the JAX
  startup runs, every persistable it wrote is carried into a port scope
  (``scope_from_numpy``), then each feed of ``feeds`` runs one step in
  both: returns (jax fetches, port fetches, jax scope, port scope), the
  fetches one list of float64 arrays a step.
- ``run_jax_exact(builder, kwargs, feeds, tmp)``: the JAX side of a
  bfloat16 comparison, in a fresh interpreter with XLA's excess precision
  off (``--xla_allow_excess_precision=false``).  XLA's CPU backend keeps
  the float32 value of a bfloat16 intermediate that it fuses into the
  next op instead of rounding it, which the port (and the program's
  declared types) do; with the flag on, the two packages part by about
  one bfloat16 rounding of such values (a loss 2e-4 apart after one
  step of the strategy-test network), with it off they agree to float32
  rounding.
- ``net(p)``: the JAX package's strategy-test network (two relu fc
  layers and a regression head, constant weights); ``data`` its inputs.
"""
import json
import os
import subprocess
import sys
from importlib import import_module

import numpy as np

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_ernie_models import one_device_mesh


def build_both(fn):
    out = []
    for p in (J, T):
        unique = import_module(p.__name__ + ".framework.unique_name")
        with unique.guard():
            if p is J:
                with one_device_mesh():
                    out.append(fn(p))
            else:
                out.append(fn(p))
    return out


def _names(fetch):
    return [f if isinstance(f, str) else f.name for f in fetch]


def run_both(jparts, tparts, feeds, fetch, init_override=None):
    from paddle_tpu_torch.framework.scope import scope_from_numpy

    jmain, jstart = jparts[0], jparts[1]
    tmain = tparts[0]
    names = _names(fetch)
    jscope = J.framework.Scope()
    jexe = J.Executor(J.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.get_var(v.name))
            for v in jstart.global_block.vars.values()
            if v.persistable and jscope.has_var(v.name)}
    init.update(init_override or {})
    tscope = scope_from_numpy(init, device="cpu")
    texe = T.Executor(T.CPUPlace())
    got, want = [], []
    for feed in feeds:
        with one_device_mesh():
            w = jexe.run(jmain, feed=feed, fetch_list=names, scope=jscope)
        g = texe.run(tmain, feed=feed, fetch_list=names, scope=tscope)
        want.append([np.asarray(x, np.float64) for x in w])
        got.append([np.asarray(x, np.float64) for x in g])
    return want, got, jscope, tscope


def net(p, x_dim=8, hidden=16):
    init = p.initializer.ConstantInitializer
    attr = p.param_attr.ParamAttr
    layers = p.layers
    main, startup = p.framework.Program(), p.framework.Program()
    main.random_seed = 1
    with p.framework.program_guard(main, startup):
        x = layers.data("x", [x_dim])
        y = layers.data("y", [1])
        h = layers.fc(x, hidden, act="relu", param_attr=attr(
            initializer=init(0.1)), bias_attr=False)
        h2 = layers.fc(h, hidden, act="relu", param_attr=attr(
            initializer=init(0.05)), bias_attr=False)
        pred = layers.fc(h2, 1, param_attr=attr(
            initializer=init(0.2)), bias_attr=False)
        loss = layers.mean(layers.square_error_cost(pred, y))
    return main, startup, loss, h


def data(seed=0, n=16, x_dim=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, x_dim).astype("float32")
    return {"x": x, "y": (x.sum(axis=1, keepdims=True) * 0.3)
            .astype("float32")}


OPTIMIZERS = {
    "momentum": lambda p: p.optimizer.MomentumOptimizer(0.05, 0.9),
    "adam": lambda p: p.optimizer.AdamOptimizer(0.01),
    "sgd": lambda p: p.optimizer.SGDOptimizer(0.05),
}


def strategy_net(p, opt="momentum", ckpt=False, **on):
    """``net`` minimized through ``fleet`` with the strategy flags and
    configs ``on`` (``ckpt``: recompute checkpointed at the first hidden
    layer): (main, startup, [loss])."""
    fleet = import_module(p.__name__ + ".distributed.fleet")
    main, startup, loss, h = net(p)
    strategy = fleet.DistributedStrategy()
    if ckpt:
        on["recompute_configs"] = {"checkpoints": [h.name]}
    for k, v in on.items():
        setattr(strategy, k, v)
    fleet_minimize(p, main, startup, loss, OPTIMIZERS[opt](p), strategy)
    return main, startup, [loss]


def fleet_minimize(p, main, startup, loss, opt, strategy):
    """``fleet.init`` / ``distributed_optimizer`` / ``minimize`` under
    ``main``'s guard."""
    fleet = import_module(p.__name__ + ".distributed.fleet")
    with p.framework.program_guard(main, startup):
        fleet.init(is_collective=True, strategy=strategy)
        fleet.distributed_optimizer(opt)
        fleet.minimize(loss)


_JAX_EXACT = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import paddle_tpu as J
from importlib import import_module
mod, fn = sys.argv[1].split(":")
kwargs, tmp = json.loads(sys.argv[2]), sys.argv[3]
main, startup, fetch = getattr(import_module(mod), fn)(J, **kwargs)
names = [f if isinstance(f, str) else f.name for f in fetch]
feeds = np.load(tmp + "/feeds.npz")
n = len({k.split(":")[0] for k in feeds})
scope = J.framework.Scope()
exe = J.Executor(J.CPUPlace())
exe.run(startup, scope=scope)
out = {"init:" + v.name: np.asarray(scope.get_var(v.name))
       for v in startup.global_block.vars.values()
       if v.persistable and scope.has_var(v.name)}
for i in range(n):
    feed = {k.split(":", 1)[1]: feeds[k] for k in feeds
            if k.split(":")[0] == str(i)}
    got = exe.run(main, feed=feed, fetch_list=names, scope=scope)
    for j, g in enumerate(got):
        out[f"step{i}:{j}"] = np.asarray(g, np.float64)
np.savez(tmp + "/jax.npz", **out)
"""


def run_jax_exact(builder, kwargs, feeds, tmp):
    """(init values, fetches a step) of ``builder`` ("module:function",
    called as ``function(paddle_tpu, **kwargs)`` and returning (main,
    startup, fetches)) run by the JAX package over ``feeds`` from its own
    startup, in a fresh interpreter without XLA's excess precision."""
    tmp = str(tmp)
    np.savez(tmp + "/feeds.npz", **{f"{i}:{k}": v for i, f in
                                    enumerate(feeds) for k, v in f.items()})
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([here, os.path.dirname(here)]))
    done = subprocess.run(
        [sys.executable, "-c", _JAX_EXACT, builder, json.dumps(kwargs), tmp],
        capture_output=True, text=True, timeout=240, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    out = np.load(tmp + "/jax.npz")
    init = {k[5:]: out[k] for k in out.files if k.startswith("init:")}
    steps = [[out[f"step{i}:{j}"] for j in range(len(
        [k for k in out.files if k.startswith(f"step{i}:")]))]
        for i in range(len(feeds))]
    return init, steps


def run_port(tparts, init, feeds, fetch):
    """The port's fetches a step over ``feeds`` from ``init``."""
    from paddle_tpu_torch.framework.scope import scope_from_numpy

    scope = scope_from_numpy(init, device="cpu")
    exe = T.Executor(T.CPUPlace())
    names = _names(fetch)
    return [[np.asarray(x, np.float64) for x in exe.run(
        tparts[0], feed=f, fetch_list=names, scope=scope)] for f in feeds], \
        scope
