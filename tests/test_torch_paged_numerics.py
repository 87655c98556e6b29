"""PyTorch port: the arithmetic of the paged kernels' redesign (B5 decode,
B6 chunk), emulated on the CPU.

``csrc/paged_attention.cu`` splits each row's walk over the page table
into ranges of whole pages taken by blocks of their own, and merges the
ranges' partials (m, l, acc) in a second kernel (``plan_split`` in
``ops/paged_attention.py`` plans it from shapes only).  B6,
``paged_chunk_mma_kernel``, takes its products on Hopper's tensor cores in
bfloat16 with float32 accumulation, yet is held to the float32 tolerance
``chip_smoke.py`` gives it (``TOL``: 3e-5 absolute).  These tests redo its
steps in torch on the CPU, with inputs made from a seed with numpy:

- a float32 pool: q, K and V split into three bfloat16 pieces, P into two
  (``_split``), each product over the piece pairs (i, j) with i + j <
  max(pieces), the smaller first (``_product``): 6 + 5 products;
- an int8 pool: K and V exact in one bfloat16 piece, the score column
  multiplied by its k scale after the product, the v scale folded into P
  before P's split: 3 + 2 products;
- key blocks of 32 positions, the per-row causal limit min(length, the
  split's end) masked to -inf, scores in base-2 units, the running max
  starting at -1e30, a fresh P V per key block added as O = O alpha +
  fresh;
- a row of at most ``chunk`` positions finished by split 0, a longer one's
  live splits merged as ``paged_combine_kernel`` merges them.

The emulation is held to ``paged_chunk_attention_reference`` within half of
``TOL`` (the margin the design keeps for the tensor cores' accumulation,
which a float32 sum stands in for here) and to the JAX package's
``paged_chunk_attention`` in Pallas interpret mode.  The plan is checked
for coverage, and the wrappers for making no host sync: no length is read
on the host.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_decode_attention as jpa
from paddle_tpu_torch.ops import paged_attention as pa
from test_torch_paged_attention import _jax
from test_torch_tensor_core_bwd_numerics import _product
from test_torch_tensor_core_numerics import _split

from conftest import jax_capability

needs_pallas = pytest.mark.skipif(
    not jax_capability("pallas_interpret"),
    reason="no usable Pallas interpret mode on this jax")

TOL = 3e-5        # chip_smoke.py's float32 (and int8 pool) tolerance of B6
HALF = 0.5        # the float32 design margin
NEG_INF = -1e30
LOG2E = 1.4426950408889634
BC = pa.CHUNK_KEY_BLOCK
H, D, PAGE, PPS = 2, 64, 8, 12
CAP = PAGE * PPS


def _inputs(seed, lens, quant=False):
    """q [S, R, H, D] float32, pools of S*PPS+1 pages (int8 with scales,
    as kv_cache.quantize_kv makes them), shuffled page tables."""
    lens = np.asarray(lens, "i4")
    s, r = lens.shape
    rs = np.random.RandomState(seed)
    n_pages = s * PPS + 1
    q = rs.randn(s, r, H, D).astype("f4")
    kf = rs.randn(n_pages, PAGE, H, D).astype("f4")
    vf = rs.randn(n_pages, PAGE, H, D).astype("f4")
    table = (rs.permutation(n_pages - 1) + 1).reshape(s, PPS).astype("i4")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    if quant:
        from paddle_tpu_torch.serving.kv_cache import quantize_kv

        kp, ks = quantize_kv(t(kf))
        vp, vs = quantize_kv(t(vf))
    else:
        kp, vp, ks, vs = t(kf), t(vf), None, None
    return dict(q=t(q), k_pages=kp, v_pages=vp, page_table=t(table),
                row_lengths=t(lens), k_scales=ks, v_scales=vs)


def _gather(pages, table):
    """[P, page, H, ...] gathered by a page table to [S, pps*page, H, ...]
    in float32, undequantized."""
    s, pps = table.shape
    g = pages[table.long()].float()
    return g.reshape(s, pps * pages.shape[1], *pages.shape[2:])


def _emulate_chunk(c, nsplit=1, chunk=None, sm_scale=None, exact=False):
    """B6's arithmetic on inputs ``c`` under the plan (nsplit, chunk):
    the partials of every split, merged as the kernels merge them.
    ``exact``: the same walk and merge in float64 without the pieces, so
    that only the plan and the merge's algebra differ between plans."""
    split = (lambda t, _n: [t.double()]) if exact else _split
    q, kp, vp, table = c["q"], c["k_pages"], c["v_pages"], c["page_table"]
    s, r, h, d = q.shape
    cap = table.shape[1] * kp.shape[1]
    chunk = cap if chunk is None else chunk
    sm_scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    quant = c["k_scales"] is not None
    pieces = 1 if quant else 3
    k, v = _gather(kp, table), _gather(vp, table)        # [S, T, H, D]
    kpc, vpc = split(k, pieces), split(v, pieces)
    qpc = split(q.float(), 3)
    if quant:  # [S, 1, H, T]: a column's scale
        kscl = _gather(c["k_scales"], table).permute(0, 2, 1)[:, None]
        vscl = _gather(c["v_scales"], table).permute(0, 2, 1)[:, None]
        if exact:
            kscl, vscl = kscl.double(), vscl.double()
    dt = torch.float64 if exact else torch.float32
    lens = c["row_lengths"].long().clamp(0, cap)
    parts = []
    for i in range(nsplit):
        start = i * chunk
        lim = lens.clamp(max=start + chunk)[:, :, None, None]
        m = torch.full((s, r, h, 1), NEG_INF, dtype=dt)
        l = torch.zeros(s, r, h, 1, dtype=dt)
        o = torch.zeros(s, r, h, d, dtype=dt)
        for kb in range(start, min(start + chunk, cap), BC):
            blk = slice(kb, kb + BC)
            x = _product(qpc, [t[:, blk] for t in kpc], "srhd,sthd->srht")
            x = x * (sm_scale * LOG2E)
            if quant:
                x = x * kscl[..., blk]
            keys = torch.arange(kb, kb + x.shape[-1])
            x = x.masked_fill(keys >= lim, float("-inf"))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = p * vscl[..., blk] if quant else p
            fresh = _product(split(pv, 2), [t[:, blk] for t in vpc],
                             "srht,sthd->srhd")
            o = o * alpha + fresh
            m = m_new
        parts.append((m, l, o))
    out = _merge(parts, lens, chunk)
    return out if exact else out.to(q.dtype)


def _merge(parts, lens, chunk):
    """A row of at most ``chunk`` positions: split 0's (m, l, o), 0 where
    l == 0; a longer one: its ceil(length / chunk) live splits merged."""
    m0, l0, o0 = parts[0]
    direct = o0 / torch.where(l0 == 0, torch.ones_like(l0), l0)
    ms = torch.stack([p[0] for p in parts])               # [N, S, R, H, 1]
    live = torch.arange(len(parts))[:, None, None, None, None] \
        < ((lens + chunk - 1) // chunk)[None, :, :, None, None]
    mx = torch.where(live, ms, torch.full_like(ms, NEG_INF)).amax(0)
    w = torch.where(live, torch.exp2(ms - mx), torch.zeros_like(ms))
    den = (w * torch.stack([p[1] for p in parts])).sum(0)
    num = (w * torch.stack([p[2] for p in parts])).sum(0)
    merged = num / torch.where(den == 0, torch.ones_like(den), den)
    return torch.where((lens <= chunk)[:, :, None, None], direct, merged)


def _share(got, want):
    """The largest |got - want| over TOL."""
    return float(((got.float() - want.float()).abs() / TOL).max())


def _reference(c):
    return pa.paged_chunk_attention_reference(
        c["q"], c["k_pages"], c["v_pages"], c["page_table"],
        c["row_lengths"], k_scales=c["k_scales"], v_scales=c["v_scales"])


def _plan(c):
    s, r, h, _d = c["q"].shape
    return pa.plan_chunk(s, r, h, c["page_table"].shape[1],
                         c["k_pages"].shape[1])


# (label, row lengths [S, R]): a whole-prompt prefill over two row tiles
# (causal 1..80), a chunk at an offset, speculative verify (3 slots x 4
# rows), rows of length 0 beside full ones and past the table's width
_CASES = {
    "prefill": [list(range(1, 81))],
    "chunk_at_offset": [list(range(41, 57))],
    "verify": [[5, 6, 7, 8], [60, 61, 62, 63], [93, 94, 95, 96]],
    "zero_and_clamped": [[0, CAP, 0, CAP + 40], [16, 32, 0, 1]],
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_b6_float32_split_meets_the_tolerance(case):
    c = _inputs(0, _CASES[case])
    got = _emulate_chunk(c, *_plan(c))
    assert _share(got, _reference(c)) <= HALF


@pytest.mark.parametrize("case", ["prefill", "verify"])
def test_b6_int8_one_piece_meets_the_tolerance(case):
    """int8 K and V in one exact bfloat16 piece, k scale on the score,
    v scale in P before its split."""
    c = _inputs(1, _CASES[case], quant=True)
    assert torch.equal(_split(c["k_pages"].float(), 1)[0],
                       c["k_pages"].float())
    got = _emulate_chunk(c, *_plan(c))
    assert _share(got, _reference(c)) <= HALF


@needs_pallas
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_b6_emulation_meets_the_jax_kernel(quant):
    """The emulation against the JAX package's chunk kernel in interpret
    mode, on the same numpy inputs."""
    c = _inputs(2, _CASES["verify"], quant=quant)
    got = _emulate_chunk(c, *_plan(c))
    arrays = [None if c[k] is None else c[k].numpy()
              for k in ("q", "k_pages", "v_pages", "page_table",
                        "row_lengths", "k_scales", "v_scales")]
    want = _jax(jpa.paged_chunk_attention, "always", *arrays)
    assert _share(got, torch.from_numpy(np.array(want))) <= HALF


@pytest.mark.parametrize("kernel", ["decode", "chunk"])
def test_plan_covers_every_live_position_once(kernel):
    """For every shape and every length up to past the table's width: the
    ranges [i*chunk, min((i+1)*chunk, length)) of the live splits cover
    [0, length) once, are whole pages, and number at most nsplit; a
    decode block's range fits its shared page ids."""
    for s, r, h, pps, page in ((8, 1, 8, 64, 16), (1, 1, 8, 64, 16),
                               (8, 4, 8, 64, 16), (1, 1024, 8, 64, 16),
                               (1, 128, 8, 64, 16), (3, 7, 2, 13, 5),
                               (1, 1, 1, 1, 16), (2, 1, 4, 2048, 16)):
        if kernel == "decode":
            nsplit, chunk = pa.plan_decode(s, h, pps, page)
            assert chunk // page <= pa.DECODE_MAX_SPLIT_PAGES
        else:
            nsplit, chunk = pa.plan_chunk(s, r, h, pps, page)
        cap = pps * page
        assert chunk % page == 0 and nsplit * chunk >= cap
        assert (nsplit - 1) * chunk < cap      # no split is always empty
        for length in range(cap + 2):
            live = min(length, cap)
            n_live = -(-live // chunk)
            assert n_live <= nsplit
            seen = np.zeros(cap, int)
            for i in range(n_live):
                seen[i * chunk:min((i + 1) * chunk, live)] += 1
            assert (seen[:live] == 1).all() and (seen[live:] == 0).all()


def test_no_split_when_the_grid_fills_the_card():
    # B5: 16 slots x 64 heads = 1024 blocks; B6: 8 slots x 16 tiles x 32
    # heads
    assert pa.plan_decode(16, 64, 64, 16) == (1, 1024)
    assert pa.plan_chunk(8, 1024, 32, 64, 16) == (1, 1024)
    # the main path's shapes do split
    assert pa.plan_decode(8, 8, 64, 16)[0] > 1
    assert pa.plan_chunk(1, 1024, 8, 64, 16)[0] > 1
    assert pa.plan_chunk(1, 16, 8, 64, 16)[0] > 1


@pytest.mark.parametrize("case", ["prefill", "zero_and_clamped"])
def test_split_merge_equals_the_unsplit_walk(case):
    """One walk over the whole width and the plan's ranges merged, the
    rest of the arithmetic exact (float64): equal within 1e-6, so the
    plan and the merge change nothing but float32 rounding; the
    zero-length rows exactly 0.  (With the kernel's float32 pieces the
    two differ by float32 summation order, ~1e-6 at |out| ~ 0.5, each as
    close to the plain version as the other.)"""
    c = _inputs(3, _CASES[case])
    nsplit, chunk = _plan(c)
    assert nsplit > 1
    split = _emulate_chunk(c, nsplit, chunk, exact=True)
    whole = _emulate_chunk(c, exact=True)
    assert float((split - whole).abs().max()) <= 1e-6
    dead = c["row_lengths"] == 0
    assert bool((split[dead] == 0).all()) and bool((whole[dead] == 0).all())


def test_empty_ranges_add_nothing():
    """Splits past a row's length (their blocks exit at once) are left out
    of the merge: giving them garbage partials changes nothing."""
    c = _inputs(4, [[10, 70, 0, 33]])
    nsplit, chunk = 6, 16
    lens = c["row_lengths"].long()
    parts = []
    for i in range(nsplit):
        m = torch.full((1, 4, H, 1), 3.0 * i)
        parts.append((m, torch.full_like(m, 1.0 + i),
                      torch.full((1, 4, H, D), float(i))))
    clean = _merge(parts, lens, chunk)
    live = (lens + chunk - 1) // chunk
    dirty = [(torch.where(i >= live[..., None, None], torch.nan, m), l, o)
             for i, (m, l, o) in enumerate(parts)]
    got = _merge(dirty, lens, chunk)
    assert torch.equal(got, clean) and bool(torch.isfinite(got).all())


_SYNCS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


@pytest.mark.parametrize("kernel", ["decode", "chunk"])
def test_wrappers_read_no_length_on_the_host(kernel, monkeypatch):
    """The wrapper's path on a card's tensors, with ``meta`` tensors
    standing in for them (the device check and the launch mocked): no
    call that waits for the card, and the workspace and plan it passes
    are the plan's."""
    launches = []
    monkeypatch.setattr(pa, "_check_launch", lambda *a, **k: None)
    monkeypatch.setattr(pa, "_launch",
                        lambda name, *a: launches.append((name, a)))

    def refuse(*_a, **_k):
        raise AssertionError("a host sync on the kernel path")
    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    s, r, h, d, page, pps = 8, 4, 8, 64, 16, 64
    meta = dict(device="meta")
    pool = torch.empty(s * pps + 1, page, h, d, **meta)
    table = torch.empty(s, pps, dtype=torch.int32, **meta)
    if kernel == "decode":
        q = torch.empty(s, h, d, **meta)
        lens = torch.empty(s, dtype=torch.int32, **meta)
        out = pa.paged_decode_attention(q, pool, pool, table, lens)
        rows, (nsplit, chunk) = s, pa.plan_decode(s, h, pps, page)
    else:
        q = torch.empty(s, r, h, d, **meta)
        lens = torch.empty(s, r, dtype=torch.int32, **meta)
        out = pa.paged_chunk_attention(q, pool, pool, table, lens)
        rows, (nsplit, chunk) = s * r, pa.plan_chunk(s, r, h, pps, page)
    assert out.shape == q.shape and len(launches) == 1
    _name, (*_tensors, _out, ws, dims, _scale) = launches[0]
    if kernel == "chunk":  # the last: the query rows a block
        assert dims[-1] == pa.chunk_tile_rows(r)
        dims = dims[:-1]
    assert nsplit > 1 and tuple(dims[-2:]) == (nsplit, chunk)
    assert ws.dtype == torch.float32 and \
        ws.numel() == rows * h * nsplit * (d + 4)
