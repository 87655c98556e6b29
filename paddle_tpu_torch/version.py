"""`paddle.version` equivalent (reference python/paddle/version.py,
generated at build time there; static here).

Counterpart of ``paddle_tpu/version.py``: the same version numbers, so a
program that checks them sees one framework version in both packages.
"""
full_version = "0.3.0"
major = "0"
minor = "3"
patch = "0"
rc = "0"
istaged = True
commit = "pytorch-cuda"   # the PyTorch / CUDA port of the same version
with_mkl = "OFF"          # no MKL build of its own: torch's kernels run


def show():
    print(f"full_version: {full_version}")
    print(f"commit: {commit}")


def mkl():
    return with_mkl
