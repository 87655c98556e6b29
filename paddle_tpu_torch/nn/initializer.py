"""`paddle.nn.initializer` namespace (reference python/paddle/nn/
initializer/): the 2.0 spellings over the fluid initializer classes.
Counterpart of ``paddle_tpu/nn/initializer.py``."""
from ..initializer import (  # noqa: F401
    ConstantInitializer as Constant,
    MSRAInitializer,
    NormalInitializer as Normal,
    NumpyArrayInitializer as Assign,
    TruncatedNormalInitializer as TruncatedNormal,
    UniformInitializer as Uniform,
    XavierInitializer,
)


class XavierNormal(XavierInitializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in, fan_out=fan_out)


class XavierUniform(XavierInitializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in, fan_out=fan_out)


class KaimingNormal(MSRAInitializer):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in)


class KaimingUniform(MSRAInitializer):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in)
