"""Vision models of the port: the static-graph ResNet builders
(``static_models``, a copy of the JAX package's) and the dygraph models
(``models``: LeNet, the ResNet family).  Counterpart of
``paddle_tpu/vision/__init__.py``, whose other models, datasets and
transforms come with later slices."""
from . import models, static_models  # noqa: F401
from .models import (  # noqa: F401
    LeNet,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from .static_models import resnet, resnet50_train_program  # noqa: F401
