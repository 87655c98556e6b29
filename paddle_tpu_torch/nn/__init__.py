"""`paddle.nn` equivalent (reference python/paddle/nn/__init__.py).

Counterpart of ``paddle_tpu/nn/__init__.py``, with the layers of
``layer/{common,container,conv,norm,pooling,activation,loss}.py``, the
functional API, the 2.0 initializers, gradient clipping (``clip``) and
``utils`` (weight and spectral norm, parameter vectors).  The recurrent
and transformer layers come with a later slice of the port.
"""
from ..dygraph.layers import Layer  # noqa: F401
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, SELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh,
    Tanhshrink, ThresholdedReLU,
)
from .layer.common import (  # noqa: F401
    CosineSimilarity, Dropout, Dropout2D, Embedding, Flatten, Linear, Pad2D,
    Upsample,
)
from .layer.container import LayerList, ParameterList, Sequential  # noqa: F401
from .layer.conv import Conv2D, Conv2DTranspose  # noqa: F401
from .layer.loss import (  # noqa: F401
    BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss, L1Loss, MSELoss, NLLLoss,
    SmoothL1Loss,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm, InstanceNorm2D,
    LayerNorm, SyncBatchNorm,
)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D, MaxPool2D,
)

from ..dygraph.tensor import Parameter  # noqa: F401
