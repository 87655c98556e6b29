"""PyTorch port: ``utils``, ``version``, ``TPUPlace`` and the typing
names of ``API.spec``, against the JAX package where it has them.

- ``try_import``, ``deprecated``'s visible warning (once per call site),
  ``download`` raising before any connection is tried, and ``unique_name``
  re-exported, as in the JAX package's ``utils``;
- ``run_check`` raises here, where torch sees no card (it has no CPU
  fallback; ``chip_smoke.py``'s ``op_library`` phase runs it on the card);
- the version numbers equal the JAX package's; ``commit`` names the port;
- ``TPUPlace(i)`` is CUDA card ``i`` (with the card count mocked), and
  raises without a card.
"""
import socket
import warnings

import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T


def test_try_import():
    assert T.utils.try_import("math").sqrt(4.0) == 2.0
    with pytest.raises(ImportError, match="not installed"):
        T.utils.try_import("no_such_module_for_the_port")
    with pytest.raises(ImportError, match="install it"):
        T.utils.try_import("no_such_module_for_the_port", "install it")


def test_deprecated_warns_once_per_call_site():
    @T.utils.deprecated(update_to="new_fn", since="0.3")
    def old_fn(x):
        return x + 1

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        for _ in range(3):
            assert old_fn(1) == 2        # one call site, three calls
        assert old_fn(2) == 3            # a second site
    msgs = [str(w.message) for w in seen
            if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 2
    assert "old_fn is deprecated since 0.3; use new_fn instead" in msgs[0]


def test_download_raises_without_fetching(monkeypatch):
    def no_network(*a, **k):
        raise AssertionError("download tried to connect")

    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setattr(socket.socket, "connect", no_network)
    with pytest.raises(RuntimeError, match="no network"):
        T.utils.download("http://example.invalid/data.tar.gz", "mnist")


def test_unique_name_is_re_exported():
    assert T.utils.unique_name is T.framework.unique_name
    with T.utils.unique_name.guard():
        assert T.utils.unique_name.generate("fc") == "fc_0"


def test_run_check_raises_without_a_card():
    if torch.cuda.is_available():
        T.utils.run_check()          # on the card it runs its program
        return
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        T.utils.run_check()


def test_version_equals_the_jax_packages():
    for k in ("full_version", "major", "minor", "patch", "rc", "istaged"):
        assert getattr(T.version, k) == getattr(J.version, k), k
    assert T.__version__ == J.__version__ == T.version.full_version
    assert T.version.mkl() == "OFF"
    assert T.version.commit != J.version.commit


def test_version_show(capsys):
    T.version.show()
    out = capsys.readouterr().out
    assert "full_version: 0.3.0" in out and "commit: pytorch-cuda" in out


def test_tpu_place_is_the_card(monkeypatch):
    assert T.TPUPlace is T.framework.place.TPUPlace
    assert not hasattr(T.TPUPlace(0), "jax_device")
    assert not hasattr(T.CPUPlace(), "jax_device")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.TPUPlace(0).torch_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert T.TPUPlace(1).torch_device() == torch.device("cuda", 1)
    assert isinstance(T.TPUPlace(1), T.CUDAPlace)
    with pytest.raises(RuntimeError, match="out of range"):
        T.TPUPlace(2).torch_device()


def test_api_spec_typing_names_resolve():
    import typing

    assert T.optimizer.List is typing.List
    assert T.optimizer.Optional is T.amp.Optional is T.io.Optional \
        is typing.Optional
    assert T.io.Iterable is typing.Iterable
