"""``paddle_tpu_torch.distributed.fleet`` -- so far only ``elastic``'s
fault injection and device preflight (see the package docstring)."""
