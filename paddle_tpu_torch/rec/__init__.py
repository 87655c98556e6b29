"""Recommender model zoo (reference PaddleRec's wide_deep / DLRM
flagships): sparse categorical fields over a large vocabulary.
Counterpart of ``paddle_tpu/rec``."""
from .static_models import wide_deep_net, wide_deep_program  # noqa: F401

__all__ = ["wide_deep_net", "wide_deep_program"]
