"""Vision of the port: the static-graph ResNet builders
(``static_models``, a copy of the JAX package's), the dygraph models
(``models``: LeNet, ResNet, MobileNetV1/V2, VGG), the datasets
(``FakeData``, and ``MNIST``, ``Cifar10``, ``DatasetFolder`` from local
files), the host-side transforms and ``ops`` (``yolo_box``,
``deform_conv2d``, ``roi_align``, ``roi_pool``).  Counterpart of
``paddle_tpu/vision/__init__.py``."""
from . import datasets, models, ops, static_models, transforms  # noqa: F401
from .datasets import Cifar10, DatasetFolder, FakeData, ImageFolder, MNIST  # noqa: F401
from .models import (  # noqa: F401
    LeNet,
    MobileNetV1,
    MobileNetV2,
    ResNet,
    VGG,
    mobilenet_v1,
    mobilenet_v2,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    vgg11,
    vgg13,
    vgg16,
    vgg19,
)
from .static_models import resnet, resnet50_train_program  # noqa: F401
