"""Dygraph vision models of the port (counterpart of
``paddle_tpu/vision/models``): LeNet, the ResNet family, MobileNetV1/V2
and the VGG family."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock,
    BottleneckBlock,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
