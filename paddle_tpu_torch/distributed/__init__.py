"""``paddle_tpu_torch.distributed`` -- the port's distributed package.

So far it holds ``fleet.elastic``'s fault injection and device preflight,
which the disaggregated-serving router and autoscaler
(``serving/disagg.py``) use, and ``checkpoint`` (``save_sharded`` /
``load_sharded`` at one process); the rest of ``paddle_tpu.distributed`` waits
for a later slice of the port (ROADMAP.md, Queue A).
"""
