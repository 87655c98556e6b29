"""Build of the port's CUDA kernels (``build.py``)."""
