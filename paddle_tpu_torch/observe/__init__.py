"""Observability of the PyTorch port: copies of the JAX package's
host-side modules (histograms, span tracer, request traces, SLOs) and
the flight recorder with a torch environment probe."""
