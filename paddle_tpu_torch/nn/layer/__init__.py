"""The 2.0 layer classes of the port (``paddle_tpu_torch.nn`` exports them)."""
