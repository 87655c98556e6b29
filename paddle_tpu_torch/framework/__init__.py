"""Framework pieces of the PyTorch port: the FLAGS registry (a copy of
``paddle_tpu/framework/flags.py``) and the device helper."""
