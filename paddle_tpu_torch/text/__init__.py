"""Text models of the port: the static-graph BERT builders
(``static_models``, a copy of the JAX package's).  Counterpart of
``paddle_tpu/text/__init__.py``, whose datasets and decoding helpers
come with later slices."""
from . import static_models  # noqa: F401
from .static_models import bert_base_pretrain_program, bert_encoder  # noqa: F401
