"""LayerHelper: shared machinery for layer functions.

Copy of ``paddle_tpu/layer_helper.py`` (the JAX package's module imports no
JAX); the program it builds is the same, op for op.

Role parity: reference python/paddle/fluid/layer_helper.py — creates
parameters in BOTH the main program (metadata) and the startup program
(initializer op), temp vars, and appends ops to the main program.
"""
from __future__ import annotations

from .framework import unique_name
from .framework.program import default_main_program, default_startup_program
from .initializer import (
    ConstantInitializer,
    XavierInitializer,
)
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # ------------------------------------------------------------------
    def create_parameter(
        self,
        attr,
        shape,
        dtype="float32",
        is_bias=False,
        default_initializer=None,
    ):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        name = attr.name or unique_name.generate(f"{self.name}.w" if not is_bias else f"{self.name}.b")
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        # main program: metadata
        param = self.main_program.global_block.create_parameter(
            name, shape, dtype=dtype, trainable=attr.trainable
        )
        param.regularizer = attr.regularizer
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        param.need_clip = attr.need_clip
        param.initializer = init
        # startup program: var + init op
        sb = self.startup_program.global_block
        sv = sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
        init(sv, sb)
        return param

    def create_variable_for_type_inference(self, dtype="float32", stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    def create_global_variable(self, shape, dtype="float32", persistable=True, name=None, initializer=None):
        name = name or unique_name.generate(f"{self.name}.gv")
        v = self.main_program.global_block.create_var(
            name=name, shape=shape, dtype=dtype, persistable=persistable, stop_gradient=True
        )
        sb = self.startup_program.global_block
        sv = sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
        (initializer or ConstantInitializer(0.0))(sv, sb)
        return v

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.block.append_op(type, inputs, outputs, attrs)

    def append_activation(self, out_var, act):
        if act is None:
            return out_var
        act_out = self.create_variable_for_type_inference(out_var.dtype)
        act_out.shape = tuple(out_var.shape)
        self.append_op(act, {"X": out_var}, {"Out": act_out})
        return act_out
