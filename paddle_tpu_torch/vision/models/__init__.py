"""Dygraph vision models of the port (counterpart of
``paddle_tpu/vision/models``): LeNet and the ResNet family.  MobileNet
and VGG come with a later slice."""
from .lenet import LeNet  # noqa: F401
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
