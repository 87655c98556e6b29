"""ParamAttr — parameter configuration (reference python/paddle/fluid/param_attr.py).

Copy of ``paddle_tpu/param_attr.py`` (the JAX package's module imports no
JAX); the program it builds is the same, op for op.
"""
from __future__ import annotations


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        do_model_average=False,
        need_clip=True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg) -> "ParamAttr | bool":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if arg is False:
            return False
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        from .initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


WeightNormParamAttr = ParamAttr  # stub parity
