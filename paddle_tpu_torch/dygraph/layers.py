"""`Layer`: the dygraph module base class.

Counterpart of ``paddle_tpu/dygraph/layers.py`` (reference
python/paddle/fluid/dygraph/layers.py `Layer`:63): parameters, buffers,
sublayers, ``train``/``eval``, ``state_dict``/``set_state_dict`` and
forward hooks.  Parameters are made on the place (``dygraph/base.py``),
their initial values drawn by the initializers' ``eager_value`` from the
place's generator.  ``state_dict_from_numpy`` loads a ``{name: numpy
array}`` dict, with the names of ``state_dict()``'s keys (those of the
JAX package's ``Layer``), beside ``framework.scope_from_numpy``.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, Optional

import numpy as np

from ..framework import unique_name
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr
from . import base
from .tensor import Parameter, Tensor


def _eager_initialize(init, shape, dtype, is_bias):
    """Run an initializer eagerly (the startup-program path, collapsed)."""
    if init is None:
        init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
    dev = base.current_device()
    return init.eager_value([int(s) for s in shape], dtype,
                            base.generator(dev))


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype: str = "float32"):
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower())
        self._dtype = dtype
        self.training = True
        self._parameters = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._sub_layers = collections.OrderedDict()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()

    # -- naming ------------------------------------------------------------
    def full_name(self):
        return self._full_name

    # -- mode --------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    # -- registration ------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or self._dtype
        init = (attr.initializer if attr and attr.initializer is not None
                else default_initializer)
        value = _eager_initialize(init, shape, dtype, is_bias)
        name = (attr.name if attr and attr.name
                else unique_name.generate(self._full_name + (".b" if is_bias else ".w")))
        p = Parameter(value, name=name, trainable=attr.trainable if attr else True)
        if attr:
            p.optimize_attr = {"learning_rate": attr.learning_rate}
            p.regularizer = attr.regularizer
            p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[Tensor], persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # -- attribute routing ---------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning parameters")
            for d in (layers, buffers):
                if d is not None:
                    d.pop(name, None)
            params[name] = value
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning sublayers")
            for d in (params, buffers):
                if d is not None:
                    d.pop(name, None)
            layers[name] = value
        elif buffers is not None and name in buffers:
            buffers[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    # -- traversal -----------------------------------------------------------
    def children(self) -> Iterator["Layer"]:
        for l in self._sub_layers.values():
            if l is not None:
                yield l

    def named_children(self):
        for n, l in self._sub_layers.items():
            if l is not None:
                yield n, l

    def sublayers(self, include_self=False):
        out = [self] if include_self else []
        for l in self.children():
            out.extend(l.sublayers(include_self=True))
        return out

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for name, p in self._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                yield (prefix + name if not prefix else prefix + "." + name), p
        if include_sublayers:
            for lname, l in self.named_children():
                sub_prefix = prefix + "." + lname if prefix else lname
                for n, p in l.named_parameters(prefix=sub_prefix):
                    if id(p) not in seen:
                        seen.add(id(p))
                        yield n, p

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        for name, b in self._buffers.items():
            if b is not None:
                yield (prefix + "." + name if prefix else name), b
        if include_sublayers:
            for lname, l in self.named_children():
                sub_prefix = prefix + "." + lname if prefix else lname
                for n, b in l.named_buffers(prefix=sub_prefix):
                    yield n, b

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for lname, l in self.named_children():
            sub_prefix = prefix + "." + lname if prefix else lname
            yield from l.named_sublayers(prefix=sub_prefix, include_self=True)

    def apply(self, fn):
        for l in self.sublayers(include_self=True):
            fn(l)
        return self

    # -- state dict -----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix=""):
        dest = destination if destination is not None else collections.OrderedDict()
        for name, p in self._parameters.items():
            if p is not None:
                dest[structured_name_prefix + name] = p
        for name, b in self._buffers.items():
            if b is not None and name not in self._non_persistable_buffer_names:
                dest[structured_name_prefix + name] = b
        if include_sublayers:
            for lname, l in self.named_children():
                l.state_dict(destination=dest,
                             structured_name_prefix=structured_name_prefix + lname + ".")
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load values by ``state_dict()`` key (numpy arrays, Tensors or
        anything ``np.asarray`` takes), each written into its parameter
        or buffer in place; returns (missing keys, unexpected keys)."""
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            own[k].set_value(v if isinstance(v, Tensor) else np.asarray(v))
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- hooks ---------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        return _HookHandle(self._forward_pre_hooks, hook)

    def register_forward_post_hook(self, hook):
        return _HookHandle(self._forward_post_hooks, hook)

    # -- call -----------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = [f"{type(self).__name__}({extra}"]
        for name, l in self.named_children():
            sub = repr(l).replace("\n", "\n  ")
            lines.append(f"  ({name}): {sub}")
        return "\n".join(lines) + ")" if len(lines) > 1 else lines[0] + ")"

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def to(self, *args, **kwargs):
        return self  # one place: parameters are made on it


def state_dict_from_numpy(layer: Layer, arrays: Dict[str, np.ndarray]):
    """Load ``arrays`` (``{state_dict key: numpy array}``, e.g. the JAX
    package's ``Layer.state_dict()`` as numpy) into ``layer``; every key
    of either side must be on the other."""
    missing, unexpected = layer.set_state_dict(arrays)
    if missing or unexpected:
        raise KeyError(f"state dict keys differ: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return layer


class _HookHandle:
    _next_id = [0]

    def __init__(self, store, hook):
        self._store = store
        self._id = _HookHandle._next_id[0]
        _HookHandle._next_id[0] += 1
        store[self._id] = hook

    def remove(self):
        self._store.pop(self._id, None)
