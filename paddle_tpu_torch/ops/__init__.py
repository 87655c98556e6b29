"""Ops of the PyTorch port: the paged attention kernels' wrappers and
plain versions (``paged_attention``), the decode-time token samplers
(``sampling_ops``) and the quantization constants (``quant_ops``).
Importing this package builds no kernel: the CUDA library is compiled
at first launch (``native/build.py``)."""
