"""`paddle.tensor`-equivalent API (reference python/paddle/tensor/).

Counterpart of ``paddle_tpu/tensor``, ported whole: the same functions
over the same IR ops, run eagerly by the port's lowerings on torch
tensors, or appended to the static program for graph Variables.  The
few functions with no IR op (``diag``, ``kron``, ``trace``,
``logsumexp``, ``cross``, ``cholesky``, ``allclose``, ``median``,
``masked_select``, ``multinomial``, ``shard_index``) run torch directly
through ``dygraph.eager.apply_torch``, eager only, as the JAX package's
do through its ``apply_jax``.

Every function works in both execution modes: eager Tensors run the op's
lowering rule immediately; graph Variables append the op to the default
program.  Importing this package also patches the functions onto Tensor
and Variable as methods (reference monkey-patch in tensor/__init__.py +
varbase_patch_methods.py).
"""
from . import creation, linalg, logic, manipulation, math, random, search, stat  # noqa: F401
from .creation import (  # noqa: F401
    arange, assign, diag, empty, empty_like, eye, full, full_like, linspace,
    meshgrid, ones, ones_like, to_tensor, tril, triu, zeros, zeros_like,
)
from .linalg import bmm, cholesky, cross, dist, dot, matmul, mm, norm  # noqa: F401
from .logic import (  # noqa: F401
    allclose, equal, equal_all, greater_equal, greater_than, is_empty,
    less_equal, less_than, logical_and, logical_not, logical_or, logical_xor,
    not_equal,
)
from .manipulation import (  # noqa: F401
    broadcast_to, chunk, concat, expand, expand_as, flatten, flip, gather,
    gather_nd, index_select, reshape, roll, scatter, scatter_nd_add, slice,
    split, squeeze, stack, strided_slice, t, take_along_axis, tile, transpose,
    unsqueeze, unstack,
)
from .math import (  # noqa: F401
    abs, acos, acosh, add, add_n, all, any, asin, asinh, atan, atanh, cast,
    ceil, clip, cos, cosh, cumsum, divide, erf, exp, expm1, floor,
    floor_divide, increment, isfinite, isinf, isnan, log, log1p, log2, log10,
    logsumexp, max, maximum, mean, min, minimum, mod, multiply, neg, pow,
    prod, reciprocal, remainder, round, rsqrt, scale, sign, sin, sinh, sqrt,
    square, subtract, sum, tan, tanh, trace, kron,
)
from .random import multinomial, normal, rand, randint, randn, randperm, uniform  # noqa: F401
from .search import (  # noqa: F401
    argmax, argmin, argsort, index_sample, masked_select, nonzero, sort, topk,
    where,
)
from .stat import median, numel, std, var  # noqa: F401

# ---------------------------------------------------------------------------
# method patching (reference: paddle monkey-patches Variable & VarBase)
# ---------------------------------------------------------------------------
_METHODS = dict(
    # math
    add=add, subtract=subtract, multiply=multiply, divide=divide,
    pow=pow, maximum=maximum, minimum=minimum, remainder=remainder,
    exp=exp, log=log, sqrt=sqrt, rsqrt=rsqrt, abs=abs, ceil=ceil, floor=floor,
    round=round, reciprocal=reciprocal, sign=sign, square=square, erf=erf,
    sin=sin, cos=cos, tan=tan, tanh=tanh, scale=scale, clip=clip, cumsum=cumsum,
    prod=prod, isnan=isnan, isinf=isinf, isfinite=isfinite, logsumexp=logsumexp,
    trace=trace,
    # reductions (eager Tensor already has sum/mean/max/min: keep those)
    all=all, any=any,
    # linalg
    matmul=matmul, mm=mm, bmm=bmm, dot=dot, norm=norm, dist=dist, t=t,
    cholesky=cholesky,
    # logic
    equal=equal, not_equal=not_equal, less_than=less_than, less_equal=less_equal,
    greater_than=greater_than, greater_equal=greater_equal,
    logical_and=logical_and, logical_or=logical_or, logical_xor=logical_xor,
    logical_not=logical_not, equal_all=equal_all, allclose=allclose,
    # manipulation
    flatten=flatten, squeeze=squeeze, unsqueeze=unsqueeze, tile=tile,
    expand=expand, expand_as=expand_as, broadcast_to=broadcast_to, flip=flip,
    roll=roll, gather=gather, gather_nd=gather_nd, index_select=index_select,
    scatter=scatter, scatter_nd_add=scatter_nd_add, split=split, chunk=chunk,
    unstack=unstack, take_along_axis=take_along_axis, concat=None,
    # search
    argmax=argmax, argmin=argmin, argsort=argsort, sort=sort, topk=topk,
    nonzero=nonzero, masked_select=masked_select, where=None,
    # creation-ish
    zeros_like=None, ones_like=None, full_like=None,
    # stat
    std=std, var=var, median=median, numel=None,
)


def _patch(cls, override=False):
    for name, fn in _METHODS.items():
        if fn is None:
            continue
        if override or not hasattr(cls, name):
            setattr(cls, name, fn)


def _patch_variable_operators(cls):
    """Static Variables get the same dunders as eager Tensors; python
    scalars are inlined by dispatch._const_to_var."""
    cls.__add__ = lambda s, o: add(s, o)
    cls.__radd__ = cls.__add__
    cls.__sub__ = lambda s, o: subtract(s, o)
    cls.__rsub__ = lambda s, o: subtract(o, s)
    cls.__mul__ = lambda s, o: multiply(s, o)
    cls.__rmul__ = cls.__mul__
    cls.__truediv__ = lambda s, o: divide(s, o)
    cls.__rtruediv__ = lambda s, o: divide(o, s)
    cls.__pow__ = lambda s, o: pow(s, o)
    cls.__neg__ = lambda s: scale(s, -1.0)
    cls.__matmul__ = lambda s, o: matmul(s, o)
    cls.__lt__ = lambda s, o: less_than(s, o)
    cls.__le__ = lambda s, o: less_equal(s, o)
    cls.__gt__ = lambda s, o: greater_than(s, o)
    cls.__ge__ = lambda s, o: greater_equal(s, o)
    cls.astype = lambda s, d: cast(s, d)
    cls.reshape = lambda s, shape, name=None: reshape(s, shape, name)
    cls.transpose = lambda s, perm, name=None: transpose(s, perm, name)
    cls.sum = lambda s, axis=None, keepdim=False, name=None: sum(s, axis, keepdim, name)
    cls.mean = lambda s, axis=None, keepdim=False, name=None: mean(s, axis, keepdim, name)
    cls.max = lambda s, axis=None, keepdim=False, name=None: max(s, axis, keepdim, name)
    cls.min = lambda s, axis=None, keepdim=False, name=None: min(s, axis, keepdim, name)
    cls.cast = cls.astype


def _install():
    from ..dygraph.tensor import Tensor
    from ..framework.program import Variable

    _patch(Tensor)
    _patch(Variable)
    _patch_variable_operators(Variable)
    # reshape in paddle 2.x takes a shape list; Tensor method signature matches


_install()
