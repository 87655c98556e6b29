"""Vision models of the port: the static-graph ResNet builders
(``static_models``, a copy of the JAX package's).  Counterpart of
``paddle_tpu/vision/__init__.py``, whose dygraph models, datasets and
transforms come with later slices."""
from . import static_models  # noqa: F401
from .static_models import resnet, resnet50_train_program  # noqa: F401
