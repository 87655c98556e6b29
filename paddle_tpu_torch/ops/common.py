"""Shared helpers for op lowering rules.

Counterpart of ``paddle_tpu/ops/common.py`` (the helpers the ported
lowerings use).  Two differences from the JAX package, both because
torch is not jax:

- ``attr_dtype`` keeps 64-bit types: torch has no x64 switch, so an
  ``int64`` request stays ``int64`` (the JAX package collapses it to
  ``int32``);
- ``promote`` casts both operands of a binary op to the type jax's
  promotion would give.  torch lets a 0-dim tensor's type lose against a
  dimensioned one (``bf16[B,S] + f32[]`` is bf16 in torch, f32 in jax);
  the programs' dtypes were decided under jax's rule.

``adaptive_windows`` is the JAX module's, unchanged (numpy only);
``adaptive_max_with_index`` and ``bilinear_sample_chw`` are its helpers
on torch (the second over a leading batch axis), with ``jmax`` / ``jmin``
/ ``jclip``, which split a tie's gradient as jax's ``maximum`` does,
``tdiv``, a division by a Python number rounded alike on the card and the
CPU, and ``device_const``, a constant built on the device by fills.

jax's indexing rules, which torch's index ops do not follow (they assert
on a bad index, which on the card ends the CUDA context), are kept on the
device by ``gather_index`` (a plain gather: negatives wrap once, then
clamp), ``take`` (such a gather whose gradient, as jax's, drops what an
out-of-range index read), ``scatter_index`` (a scatter: negatives wrap
once, the rest out of range dropped) and ``take_along_axis`` (out of
range fills).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtypes


def attr_dtype(op, name="dtype", default="float32") -> torch.dtype:
    """Resolve a dtype attribute (IR enum int or string) to a torch dtype."""
    v = op.attr(name, None)
    if v is None or v == 0:
        return dtypes.to_torch(default)
    return dtypes.to_torch(v)


def op_generator(ctx, op) -> torch.Generator:
    """The generator a random op draws from: an explicit nonzero ``seed``
    attr wins (a fresh generator seeded with it, the reference's per-op
    seed semantics), else the program's stream."""
    seed = int(op.attr("seed", 0) or 0)
    if seed:
        return torch.Generator(device=ctx.device).manual_seed(seed)
    return ctx.next_generator()


def shard_rand(ctx, op, shape, device) -> torch.Tensor:
    """Uniform draws in [0, 1) of ``shape`` for an op whose randomness
    must differ across data-parallel ranks (dropout: each rank masks its
    own slice of the batch), the JAX package's ``op_seed_key(per_shard=
    True)``.  With a live process group of n ranks the op's generator
    draws n times the values, the same on every rank, and rank r keeps
    the r-th block: the stream advances alike everywhere (so the
    replica-invariant draws after it, as the startup's, stay equal) and
    the ranks' draws are distinct values of it.  Without a group (or
    with one rank) it is one plain draw, as before."""
    from ..distributed import parallel_env

    gen = op_generator(ctx, op)
    n = parallel_env.get_world_size()
    if n <= 1:
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)
    u = torch.rand((n,) + tuple(shape), generator=gen, dtype=torch.float32,
                   device=device)
    return u[parallel_env.get_rank()]


def promote(x: torch.Tensor, y: torch.Tensor):
    """``x``, ``y`` cast to their common type under jax's promotion."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def bcast_shapes_elementwise(x, y, axis: int):
    """Reference elementwise broadcast: align y's dims to x starting at
    `axis` (reference operators/elementwise/elementwise_op_function.h trim/
    expand semantics), then rely on numpy-style broadcasting."""
    if x.dim() == y.dim() or y.dim() == 0:
        return x, y
    if y.dim() > x.dim():
        # mirrored case: broadcast x into y (resolve axis against y's rank)
        y2, x2 = bcast_shapes_elementwise(y, x, axis)
        return x2, y2
    if axis == -1:
        axis = x.dim() - y.dim()
    new_shape = [1] * x.dim()
    new_shape[axis: axis + y.dim()] = list(y.shape)
    return x, y.reshape(new_shape)


def as_scalar(x):
    """Ops like adam receive the learning rate as a [1] tensor."""
    return x.reshape(()) if isinstance(x, torch.Tensor) and x.numel() == 1 \
        else x


def adaptive_windows(size: int, out_size: int):
    """Adaptive-pool window indices (reference AdaptiveStartIndex/
    AdaptiveEndIndex: cell i covers [floor(i*S/O), ceil((i+1)*S/O))):
    returns (idx [out, maxw] clipped, valid mask, maxw)."""
    starts = (np.arange(out_size) * size) // out_size
    ends = -(-(np.arange(1, out_size + 1) * size) // out_size)  # ceil
    maxw = int((ends - starts).max())
    idx = starts[:, None] + np.arange(maxw)[None, :]
    valid = idx < ends[:, None]
    return np.minimum(idx, size - 1), valid, maxw


def device_const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor of ``values`` (a flat list) built on
    ``device`` by fills: no host-to-device copy, which a captured step
    could not hold."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


def tdiv(x: torch.Tensor, v) -> torch.Tensor:
    """``x / v`` for a Python number ``v``, rounded as the CPU (and jax)
    round it: torch's CUDA kernels multiply by ``1 / v`` instead, one
    rounding more, and a floor, ceil or comparison after it could then
    move by one on the card."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def jmax(x: torch.Tensor, lo) -> torch.Tensor:
    """``jnp.maximum(x, lo)`` for a Python ``lo``: a tie splits the
    gradient in half, as jax's does (``clamp_min`` gives it all to x)."""
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype,
                                       device=x.device))


def jmin(x: torch.Tensor, hi) -> torch.Tensor:
    """``jnp.minimum(x, hi)`` for a Python or tensor ``hi``, ties split."""
    if not isinstance(hi, torch.Tensor):
        hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(x, hi)


def jclip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, so a value on a
    bound passes half its gradient, as in jax."""
    return jmin(jmax(x, lo), hi)


def adaptive_max_with_index(x, out_sizes):
    """N-D non-divisible adaptive max pool with flat argmax indices.

    ``x`` is [N, C, *spatial]; each output cell gathers its variable
    floor/ceil window through a fixed max-width index table (built on
    x's device) and reduces under a validity mask; the masked argmax (the
    first maximum) decomposes back into original coordinates to give the
    reference Mask contract (flat index into the unpadded spatial
    volume).  ``amax`` splits a tie's gradient evenly, as ``jnp.max``.
    Returns (out, flat_int32).
    """
    spatial = len(out_sizes)
    in_sp = [int(s) for s in x.shape[2:2 + spatial]]
    dev = x.device
    tabs = []
    for size, o in zip(in_sp, out_sizes):
        o = int(o)
        maxw = adaptive_windows(size, o)[2]
        cell = torch.arange(o, device=dev)
        starts = torch.div(cell * size, o, rounding_mode="floor")
        ends = -torch.div(-(cell + 1) * size, o, rounding_mode="floor")
        idx = starts[:, None] + torch.arange(maxw, device=dev)[None, :]
        tabs.append((idx.clamp(max=size - 1), idx < ends[:, None], maxw))
    g = x
    for i, (idx, _, maxw) in enumerate(tabs):
        axis = 2 + 2 * i  # dims before it already split into (o, m)
        g = torch.index_select(g, axis, idx.reshape(-1))
        g = g.reshape(g.shape[:axis] + (idx.shape[0], maxw)
                      + g.shape[axis + 1:])
    perm = ([0, 1] + [2 + 2 * i for i in range(spatial)]
            + [3 + 2 * i for i in range(spatial)])
    g = g.permute(perm)  # [N, C, o..., m...]
    mask = None
    for i, (_, valid, _) in enumerate(tabs):
        shape = [1] * (2 * spatial)
        shape[i], shape[spatial + i] = valid.shape
        m = valid.reshape(shape)
        mask = m if mask is None else (mask & m)
    lowest = float("-inf") if g.is_floating_point() \
        else torch.iinfo(g.dtype).min
    gm = torch.where(mask, g, torch.full((), lowest, dtype=g.dtype,
                                         device=dev))
    maxws = [t[2] for t in tabs]
    head = tuple(gm.shape[:2 + spatial])
    flatwin = gm.reshape(head + (-1,))
    out = flatwin.amax(dim=-1)
    rem = flatwin.argmax(dim=-1)  # window-local flat, first maximum
    ks = []
    for i in reversed(range(spatial)):
        ks.append(rem % maxws[i])
        rem = torch.div(rem, maxws[i], rounding_mode="floor")
    ks.reverse()
    flat = torch.zeros_like(ks[0])
    stride = 1
    for i in reversed(range(spatial)):
        # map each axis's window-local index through its table to the
        # ORIGINAL coordinate
        idx = tabs[i][0]
        cell_shape = [1] * (2 + spatial)
        cell_shape[2 + i] = idx.shape[0]
        cell = torch.arange(idx.shape[0], device=dev).reshape(cell_shape)
        coord = idx[cell.expand(head), ks[i]]
        flat = flat + coord * stride
        stride *= in_sp[i]
    return out, flat.to(torch.int32)


def bilinear_sample_chw(img, ys, xs, padding="zeros"):
    """Bilinear sampling of img [B, C, H, W] at float coords ys/xs
    [B, ...] -> [B, C, ...]: the JAX package's helper of the same name
    (one [C, H, W] image) over a leading batch axis.

    padding="zeros": out-of-range taps contribute 0 (reference
    DmcnIm2colBilinear / grid_sampler zeros semantics — the validity
    test runs on the UNCLIPPED coordinate, so coords in (-1, 0) get the
    partial in-range contribution).  padding="border": coords clamp to
    the edge pixel.  Shared by deformable conv and grid_sampler so the
    subtle boundary semantics live in one place.  The taps are gathers
    from the flattened image; their gradient is a scatter-add.
    """
    b, c, h, w = img.shape
    flat = img.reshape(b, c, h * w)
    shape = ys.shape
    ys = ys.reshape(b, -1)
    xs = xs.reshape(b, -1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)

    def at(yy, xx):
        yc = yy.clamp(0, h - 1).long()
        xc = xx.clamp(0, w - 1).long()
        idx = (yc * w + xc)[:, None, :].expand(b, c, yc.shape[1])
        vals = torch.gather(flat, 2, idx)
        if padding == "zeros":
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            vals = vals * valid[:, None].to(img.dtype)
        return vals

    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]
    out = (at(y0, x0) * (1 - wy) * (1 - wx)
           + at(y0, x0 + 1) * (1 - wy) * wx
           + at(y0 + 1, x0) * wy * (1 - wx)
           + at(y0 + 1, x0 + 1) * wy * wx)
    return out.reshape((b, c) + tuple(shape[1:]))


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The int64 index ``x[idx]`` reads in jax along an axis of ``n``: a
    negative index wraps once (``+ n``), then the index is clamped into
    [0, n - 1]."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def grad_only_where(out: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``out`` unchanged, its gradient passed only where ``valid``
    (broadcast over ``out``'s trailing axes): jax's gather reads a
    clamped index but its gradient, a scatter, drops an out-of-range
    one."""
    if not out.requires_grad:
        return out
    valid = valid.reshape(tuple(valid.shape)
                          + (1,) * (out.dim() - valid.dim()))
    return torch.where(valid, out, out.detach())


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0 as jax computes it: ``gather_index``'s
    index, and the gradient of a read through an index outside [-n, n)
    dropped."""
    n = x.shape[0]
    return grad_only_where(x[gather_index(idx, n)], (idx >= -n) & (idx < n))


def scatter_index(idx: torch.Tensor, n: int):
    """(index, valid) for jax's ``.at[idx]`` scatter along an axis of
    ``n``: a negative index wraps once, anything still outside [0, n) is
    dropped.  ``index`` is int64 and in range everywhere (0 where
    dropped); the caller zeroes the dropped updates with ``valid``."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def take_along_axis(x: torch.Tensor, idx: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """``jnp.take_along_axis`` (mode "fill"): a negative index from -n
    wraps, an index outside [-n, n) gives NaN (a signed integer x: the
    type's minimum).  The gather reads a clamped index, so a bad one
    never reaches it; the filled entries get no gradient."""
    n = x.shape[dim]
    valid = (idx >= -n) & (idx < n)
    out = torch.gather(x, dim, gather_index(idx, n))
    fill = float("nan") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    return torch.where(valid, out, torch.full((), fill, dtype=x.dtype,
                                              device=x.device))
