"""PyTorch port: the public names the JAX package exports at top level
(``serving``, ``distributed``, ``append_backward``, ``calc_gradient``,
``StepHandle``, ``global_scope``) resolve to the port's own objects, and
``Scope.erase`` / ``new_scope`` / ``drop_kids`` work as the JAX scope's
do.  Importing ``serving`` and ``distributed`` builds no kernel and
touches no card (checked in a fresh interpreter)."""
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T

NAMES = {
    "serving": "paddle_tpu_torch.serving",
    "distributed": "paddle_tpu_torch.distributed",
    "append_backward": "paddle_tpu_torch.framework.backward",
    "calc_gradient": "paddle_tpu_torch.framework.backward",
    "StepHandle": "paddle_tpu_torch.framework.executor",
    "global_scope": "paddle_tpu_torch.framework.scope",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_top_level_name_is_the_ports_own(name):
    assert hasattr(J, name)
    obj = getattr(T, name)
    where = getattr(obj, "__module__", None) or obj.__name__
    assert where == NAMES[name]


def test_global_scope_is_the_one_the_executor_uses():
    from paddle_tpu_torch.framework import scope as scope_mod

    assert T.global_scope() is scope_mod.global_scope()
    assert isinstance(T.global_scope(), T.framework.Scope)


@pytest.mark.parametrize("p", [J, T], ids=["jax", "port"])
def test_scope_children_erase_and_drop_kids(p):
    parent = p.framework.Scope()
    parent.set_var("w", np.ones(3, "f4"))
    kid = parent.new_scope()
    assert kid.has_var("w")
    np.testing.assert_array_equal(np.asarray(kid.get_var("w")),
                                  np.ones(3, "f4"))
    kid.set_var("only_kid", np.zeros(2, "f4"))
    assert not parent.has_var("only_kid")
    assert kid.local_var_names() == ["only_kid"]
    assert parent._kids == [kid]
    parent.drop_kids()
    assert parent._kids == []
    parent.erase("w")
    parent.erase("never_set")
    assert not parent.has_var("w") and not kid.has_var("w")
    with pytest.raises(KeyError):
        kid.get_var("w")


def test_importing_serving_and_distributed_builds_nothing():
    code = (
        "import sys, torch\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.distributed import fleet\n"
        "from paddle_tpu_torch import serving\n"
        "from paddle_tpu_torch.native import build\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not build._LIBS\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'paddle_tpu') or m.startswith('google.protobuf')]\n"
        "assert not bad, bad\n"
        "print('ok', pt.distributed.get_world_size(), fleet.worker_num())\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.dirname(T.__path__[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "1", "1"]
