"""Observability of the PyTorch port: copies of the JAX package's
host-side modules (histograms, span tracer, request traces, SLOs, the
executor's step telemetry ``step_stats``) and the flight recorder with a
torch environment probe."""
