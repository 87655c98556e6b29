"""PyTorch port: ``nn.functional.interpolate`` / ``nn.Upsample`` against
the JAX package's (``jax.image.resize``), and the ``while``-gradient
refusal's wording.

Bilinear and bicubic resizes antialias when they shrink in the JAX
package, with Keys' cubic at a = -0.5; the port passes ``antialias=True``
to ``torch.nn.functional.interpolate``, which computes the same filter.
Held within 1e-5 of the JAX result's largest magnitude
(``torch_dygraph_parity.check``: outputs and input gradients; both sum
at most 4 x 4 float32 taps a pixel, measured 5e-7 apart), up (x2) and
down (4 x 4, 5 x 11).  Nearest resizes were already equal.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from torch_dygraph_parity import _jax_eager_keys_kept, check  # noqa: F401

IMG = np.random.RandomState(4).randn(2, 3, 8, 8).astype("f4")
RTOL = 1e-5


@pytest.mark.parametrize("mode,kw", [
    ("bicubic", dict(scale_factor=2)),
    ("bilinear", dict(size=(4, 4))),
    ("bicubic", dict(size=(4, 4))),
    ("bilinear", dict(size=(5, 11))),
    ("bicubic", dict(size=(5, 11))),
    ("nearest", dict(size=(5, 11))),
])
def test_interpolate_matches_jax(mode, kw):
    check(lambda a: J.nn.functional.interpolate(a, mode=mode, **kw),
          lambda a: T.nn.functional.interpolate(a, mode=mode, **kw), IMG,
          rtol=RTOL)


@pytest.mark.parametrize("mode,kw", [("bicubic", dict(scale_factor=2)),
                                     ("bilinear", dict(size=(3, 5)))])
def test_upsample_layer_matches_jax(mode, kw):
    check(lambda a: J.nn.Upsample(mode=mode, **kw)(a),
          lambda a: T.nn.Upsample(mode=mode, **kw)(a), IMG, rtol=RTOL)


def test_while_gradient_refusal_gives_the_ports_reason():
    """The refusal stays (the JAX package refuses too); its reason is the
    port's own: ``while`` runs eagerly and has no gradient rule."""
    from paddle_tpu_torch.framework.backward import GRAD_MAKERS

    with pytest.raises(NotImplementedError) as err:
        GRAD_MAKERS["while"](None, None, {})
    msg = str(err.value)
    assert "runs eagerly" in msg and "`rnn` op" in msg and "cuDNN" in msg
    for word in ("jax", "xla", "lax"):
        assert word not in msg.lower(), word
