"""Exact-pair tiled rasterizer - the performance path.

Same math as ``ops/rasterize.py`` (homogeneous edge functions from
``triangle_setup``), scheduled for the card:

- **Exact-pair binning** (``build_pairs``, plain tensor ops): every
  triangle emits one (tile, triangle) pair per screen tile its bbox covers
  (up to ``expand``); bigger triangles emit supertile pairs, and the few
  that exceed the supertile budget land in one global bucket walked by all
  tiles. Pairs are sorted by bin (one stable sort) and the per-triangle
  records are gathered into pair order, so each tile owns a dense,
  exactly-sized range of record rows.
- **Kernels** (``csrc/pair_raster.cu``, ``csrc/pair_raster_fused.cu``): one
  thread block per tile walks its dense, supertile and global ranges and
  keeps per pixel the minimum depth and the lowest pair id at that depth.
  Both walk with ``csrc/strip_walk.cuh``, which skips, per warp, the pairs
  whose packed strip span misses the warp's rows or whose edges exclude
  the warp's pixels (``strip_walk_tests`` counts what it tests).
  ``pair_raster`` splits a crowded tile's pairs over several blocks and
  merges their winners exactly (``rasterize_pairs_split_plain`` is that
  merge in PyTorch); the fused kernel then interpolates the winner's
  attributes. Under the occlusion early-out (z-sorted bins without a span
  column) a block stops walking a range once every pixel of its tile
  lies below the range's next z bucket (``early_out_walk`` is that rule
  in PyTorch, skip count included).

Depth is evaluated in barycentric form, ``d = sum_i e_i * zc_i``: the
algebraically-equivalent folded screen-linear form cancels
catastrophically near z ~ 1, where shadow projections pack their depth.
Edge values and depth are fused multiply-adds in the JAX package's
compiled order (``ops/rasterize.py::edge_value``, ``plane_depth``; the
kernels use ``__fmaf_rn``, which ``-fmad=false`` leaves in place).

Beside each kernel stands its plain PyTorch version
(``rasterize_pairs_plain``, ``rasterize_pairs_fused_plain``) on the same
``PairedTriangles``: it runs for CPU tensors, in the tests, and as the
yardstick the kernels are held against on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from zeldaengine_tpu_torch.ops import _build
from zeldaengine_tpu_torch.ops.rasterize import (
    TriangleSetup, edge_value, plane_depth)


class PairedTriangles(NamedTuple):
    """Exact (tile, triangle) pair stream for the pair rasterizer.

    ``records`` holds per-PAIR rasterization records gathered into sorted
    pair order, one row-major row per pair; tile t's pairs occupy the
    contiguous index range [starts[t], ends[t]). Triangles whose bbox
    covers more than ``expand`` tiles get SUPERTILE pairs (a supertile is
    ``super_h x super_w`` tiles; range [sstarts[s], sends[s]) walked by
    each of the supertile's tiles); only triangles too big for the
    supertile budget land in the global bucket [gbounds[0], gbounds[1])
    walked by every tile."""

    records: torch.Tensor  # (P, rec_w) float32
    pair_tri: torch.Tensor  # (P,) int32 original triangle id
    starts: torch.Tensor  # (n_tiles,) int32 first pair index of the tile
    ends: torch.Tensor  # (n_tiles,) int32 one-past-last pair index
    sstarts: torch.Tensor  # (n_super,) int32 supertile range start
    sends: torch.Tensor  # (n_super,) int32 supertile range end
    gbounds: torch.Tensor  # (2,) int32 global-bucket [start, end)
    # Number of LIVE pairs dropped by the ``max_pairs`` capacity (0 when
    # uncapped), a () int32 tensor.
    overflow: torch.Tensor | int = 0


# Supertile geometry and its pair budget: a triangle covering more than
# ``expand`` tiles emits up to SUPER_EXPAND supertile pairs (each walked by
# super_h*super_w tiles) before falling into the global bucket walked by
# EVERY tile. The supertile PIXEL footprint stays constant (64 x 512 px)
# as the tile shape changes.
SUPER_W = 4
SUPER_EXPAND = 4


def _super_h(tile_h: int) -> int:
    """Supertile height in tiles: fixed 64-px footprint."""
    return max(1, 64 // tile_h)


def _super_w(tile_w: int) -> int:
    """Supertile width in tiles: fixed 512-px footprint."""
    return max(1, (SUPER_W * 128) // max(tile_w, 1))


def _covers_pixel_center(bbox):
    """EXACT sub-pixel cull: coverage samples pixel CENTERS (x + 0.5), so
    a triangle whose bbox straddles no center in x or in y rasterizes zero
    pixels anywhere. Conservative: only culls when the bbox PROVABLY
    contains no center."""
    has_cx = torch.floor(bbox[:, 2] - 0.5) + 0.5 >= bbox[:, 0]
    has_cy = torch.floor(bbox[:, 3] - 0.5) + 0.5 >= bbox[:, 1]
    return has_cx & has_cy


def compact_setup(setup: TriangleSetup, cap: int,
                  extra: Optional[torch.Tensor] = None,
                  center_cull: bool = False):
    """Compact live triangles into a ``cap``-sized prefix.

    At meshlet scale (a 1M-triangle pool, most of it culled by the frustum
    and cone tests) the pair binning would sort T * expand keys and gather
    T-sized records whatever the cull kept; compacting the live (post-cull,
    on-screen) triangles first makes every later cost track the live count:
    one cumulative sum and one T-element scatter.

    Returns (setup', extra', idx, overflow): ``idx`` (cap,) int32 maps
    compacted rows to ORIGINAL triangle ids (T for dead padding rows, whose
    rows are zeros with ``valid`` False), for ``remap_pair_tri``;
    ``overflow`` () int32 counts the live triangles the cap dropped, the
    highest ids first: max(n_live - cap, 0).
    """
    t = setup.edge.shape[0]
    dev = setup.edge.device
    bbox = setup.bbox
    live = setup.valid & (bbox[:, 2] > bbox[:, 0]) & (bbox[:, 3] > bbox[:, 1])
    if center_cull:
        live = live & _covers_pixel_center(bbox)
    pos = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
    n_live = pos[-1] + 1 if t > 0 else torch.zeros((), dtype=torch.int32,
                                                    device=dev)
    tgt = torch.where(live & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.full((cap + 1,), t, dtype=torch.int32, device=dev)
    # Every dead or dropped triangle lands on the extra slot ``cap``.
    idx[tgt.long()] = torch.arange(t, dtype=torch.int32, device=dev)
    idx = idx[:cap]
    overflow = torch.clamp_min(n_live - cap, 0).to(torch.int32)
    rows = torch.clamp_max(idx, max(t - 1, 0)).long()
    dead = idx >= t

    def g(a):
        # The cap rows only: no copy of the T-row array with a pad row.
        out = a[rows] if t > 0 else a.new_zeros((cap, *a.shape[1:]))
        return torch.where(dead.view(-1, *[1] * (a.dim() - 1)),
                           torch.zeros((), dtype=a.dtype, device=dev), out)

    setup2 = TriangleSetup(
        edge=g(setup.edge), zc=g(setup.zc), valid=g(setup.valid),
        bbox=g(setup.bbox),
        zmin=None if setup.zmin is None else g(setup.zmin))
    return setup2, None if extra is None else g(extra), idx, overflow


def remap_pair_tri(pairs: PairedTriangles, idx: torch.Tensor,
                   orig_t: int) -> PairedTriangles:
    """Map compacted ``pair_tri`` back to original triangle ids (dead pairs,
    which carry the compacted count, -> ``orig_t``: the uncompacted dead
    convention)."""
    idx_pad = torch.cat([idx, torch.full((1,), orig_t, dtype=torch.int32,
                                         device=idx.device)])
    return pairs._replace(pair_tri=idx_pad[pairs.pair_tri.long()])


def count_oversized(setup: TriangleSetup, width: int, height: int,
                    tile_h: int, tile_w: int, expand: int) -> torch.Tensor:
    """Validation counter: triangles that fall into the GLOBAL bucket
    every tile walks - bbox covers more than ``expand`` tiles AND more
    than SUPER_EXPAND supertiles (the middle tier absorbs medium
    triangles). A () int32 tensor."""
    bbox = setup.bbox
    n_tx = -(-width // tile_w)
    n_ty = -(-height // tile_h)
    tx0 = torch.clamp(torch.floor(bbox[:, 0] / tile_w), 0, n_tx - 1)
    ty0 = torch.clamp(torch.floor(bbox[:, 1] / tile_h), 0, n_ty - 1)
    tx1 = torch.clamp(torch.ceil(bbox[:, 2] / tile_w) - 1.0, 0, n_tx - 1)
    ty1 = torch.clamp(torch.ceil(bbox[:, 3] / tile_h) - 1.0, 0, n_ty - 1)
    live = (setup.valid & (bbox[:, 2] > bbox[:, 0])
            & (bbox[:, 3] > bbox[:, 1]) & (bbox[:, 2] > 0)
            & (bbox[:, 0] < width))
    ncov = (tx1 - tx0 + 1.0) * (ty1 - ty0 + 1.0)
    super_w = _super_w(tile_w)
    super_h = _super_h(tile_h)
    ncov_s = ((torch.floor(tx1 / super_w) - torch.floor(tx0 / super_w) + 1.0)
              * (torch.floor(ty1 / super_h) - torch.floor(ty0 / super_h)
                 + 1.0))
    return torch.sum(live & (ncov > expand)
                     & (ncov_s > SUPER_EXPAND)).to(torch.int32)


def build_pairs(
    setup: TriangleSetup,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    expand: int = 8,
    y0_tiles: int = 0,
    extra: Optional[torch.Tensor] = None,
    max_pairs: Optional[int] = None,
    sort_z: bool = False,
    align: bool = False,
    ysort_sub_rows: Optional[int] = None,
    gather_chunks: int = 1,
    gather_pack: int = 1,
    center_cull: bool = False,
) -> PairedTriangles:
    """Compact triangles into exact per-tile pair lists.

    ``extra``: optional (T, E) float32 per-triangle payload columns
    appended to the 12 rasterization columns (record columns 12..12+E-1,
    the row width rounded up to a multiple of 16). The fused kernel uses
    the material-combo id + 3 corners x interpolants.

    ``sort_z``: order each bin's pairs FRONT TO BACK by the triangle's
    conservative ``setup.zmin`` (quantized into the low sort-key bits)
    instead of by triangle id. Coverage and depths are unchanged; only
    exact-depth ties between DIFFERENT triangles can resolve to another
    winner (the kernel keeps the lowest PAIR id among minimum-depth
    candidates).

    ``ysort_sub_rows``: bucket each bin's pairs by the triangle's first
    covered ``sub_rows``-row strip ahead of the z order, and append a
    record column carrying the triangle's packed absolute strip span
    (``ysub1 * 4096 + ysub0``).

    The sort key is assembled in int32 with the same bit budget as the
    JAX package ((n_bins << (ybits + zbits)) < 2^31) and sorted with a
    STABLE sort: pair order within equal keys decides winners at exact
    depth ties, so both must match for the two packages to agree there.

    ``align``: every walked bin (dense, supertile, global) starts on a
    128-pair boundary; the positions between a bin's end and the next
    bin's start hold the dead triangle id (the never-record, which covers
    nothing). The kernels walk the same [start, end) ranges, only the
    records move.

    ``gather_chunks`` / ``gather_pack`` are layouts of the record gather
    that only matter to the JAX package's schedule: accepted and ignored
    (every value gives the same records).
    """
    del gather_chunks, gather_pack
    edge = setup.edge
    dev = edge.device
    f32 = torch.float32
    t = edge.shape[0]
    n_tx = -(-width // tile_w)
    n_ty = -(-height // tile_h)
    n_tiles = n_ty * n_tx
    y0f = float(y0_tiles)
    # Supertile grid + the z sort-key bit budget (all static).
    super_w = _super_w(tile_w)
    n_sx = -(-n_tx // super_w)
    super_h = _super_h(tile_h)
    n_sy = -(-n_ty // super_h)
    n_super = n_sy * n_sx
    n_bins = n_tiles + n_super + 2  # dense + super + global + dead
    has_z = 1 if (sort_z and setup.zmin is not None) else 0
    has_y = 1 if ysort_sub_rows else 0
    n_sub = (tile_h // ysort_sub_rows) if has_y else 1
    ybits = max(1, (n_sub - 1).bit_length()) if has_y else 0
    # Front-to-back key low bits: (n_bins << (ybits + zbits)) < 2^31.
    zbits = (min(16, 30 - max(n_bins - 1, 1).bit_length() - ybits)
             if has_z else 0)
    zscale = float((1 << zbits) - 1) if has_z else 1.0

    n_extra = 0 if extra is None else extra.shape[1]
    rec_w = max(16, ((12 + n_extra + has_z + has_y + 15) // 16) * 16)
    never = torch.zeros((rec_w,), dtype=f32, device=dev)
    never[2] = never[5] = never[8] = -1.0
    if has_y:
        # Never-record y span: ysub0 = 4095, ysub1 = 0 (an empty span).
        never[12 + n_extra + has_z] = 4095.0
    bbox = setup.bbox
    cols = [edge.reshape(t, 9), setup.zc]
    if extra is not None:
        cols.append(extra.to(f32))
    if has_z:
        # Column 12+n_extra carries the triangle's SORT-BUCKET floor
        # (quantized zmin).
        zq_val = torch.floor(
            torch.clamp(setup.zmin, 0.0, 1.0) * zscale) / zscale
        cols.append(zq_val[:, None])
    if has_y:
        # Absolute strip span of the binning bbox, packed into one column
        # (both < 4096; the packed value < 2^24 stays exact in f32).
        ysub0 = torch.clamp(torch.floor(bbox[:, 1] / ysort_sub_rows), 0.0,
                            4095.0)
        ysub1 = torch.clamp(torch.ceil(bbox[:, 3] / ysort_sub_rows) - 1.0,
                            0.0, 4095.0)
        cols.append((ysub1 * 4096.0 + ysub0)[:, None])
    pad_cols = rec_w - 12 - n_extra - has_z - has_y
    if pad_cols:
        cols.append(torch.zeros((t, pad_cols), dtype=f32, device=dev))
    rec = torch.cat(cols, dim=1)
    rec = torch.where(setup.valid[:, None], rec, never[None, :])
    rec16 = torch.cat([rec, never[None, :]], dim=0)  # row t = dead

    # Covered tile ranges (band-relative rows).
    tx0 = torch.clamp(torch.floor(bbox[:, 0] / tile_w), 0, n_tx - 1)
    ty0 = torch.clamp(torch.floor(bbox[:, 1] / tile_h) - y0f, 0, n_ty - 1)
    tx1 = torch.clamp(torch.ceil(bbox[:, 2] / tile_w) - 1.0, 0, n_tx - 1)
    ty1 = torch.clamp(torch.ceil(bbox[:, 3] / tile_h) - 1.0 - y0f, 0,
                      n_ty - 1)
    # Live = valid AND bbox intersects this row band AND overlaps the
    # screen in x.
    live = (
        setup.valid
        & (bbox[:, 2] > bbox[:, 0])
        & (bbox[:, 3] > bbox[:, 1])
        & (bbox[:, 2] > 0)
        & (bbox[:, 0] < width)
        & (bbox[:, 3] / tile_h > y0f)
        & (bbox[:, 1] / tile_h < y0f + n_ty)
    )
    if center_cull:
        live = live & _covers_pixel_center(bbox)
    zero = torch.zeros_like(tx0)
    nx = (tx1 - tx0 + 1.0)
    ny = (ty1 - ty0 + 1.0)
    ncov = torch.where(live, nx * ny, zero)

    # Supertile ranges (two-level binning; see SUPER_* above).
    sx0 = torch.floor(tx0 / super_w)
    sy0 = torch.floor(ty0 / super_h)
    sx1 = torch.floor(tx1 / super_w)
    sy1 = torch.floor(ty1 / super_h)
    snx = sx1 - sx0 + 1.0
    ncov_s = torch.where(live, snx * (sy1 - sy0 + 1.0), zero)

    # Pair expansion: slot e of a small triangle covers tile
    # (ty0 + e // nx, tx0 + e % nx); slot e < SUPER_EXPAND of a medium
    # triangle covers supertile (sy0 + e // snx, sx0 + e % snx), keyed
    # after the dense tiles. DEAD sorts after the global bucket.
    g_key = float(n_tiles + n_super)
    dead = g_key + 1.0
    e = torch.arange(expand, dtype=f32, device=dev)[None, :]
    ey = torch.floor((e + 0.5) / nx[:, None])
    ex = e - ey * nx[:, None]
    tile = (ty0[:, None] + ey) * n_tx + (tx0[:, None] + ex)
    sey = torch.floor((e + 0.5) / snx[:, None])
    sex = e - sey * snx[:, None]
    stile = n_tiles + (sy0[:, None] + sey) * n_sx + (sx0[:, None] + sex)
    small = ncov <= expand
    med = (~small) & (ncov_s <= SUPER_EXPAND)
    dead_t = torch.full_like(tile, dead)
    keys = torch.where(
        (e < ncov[:, None]) & small[:, None], tile,
        torch.where((e < ncov_s[:, None]) & med[:, None], stile, dead_t),
    )
    # Oversized triangles: one pair in the global bucket.
    keys[:, 0] = torch.where(live & ~small & ~med,
                             torch.full_like(ncov, g_key), keys[:, 0])
    pad = (-(t * expand)) % 128

    def pad_flat(a, value):
        return torch.nn.functional.pad(a.reshape(-1), (0, pad), value=value)

    keys = pad_flat(keys, dead)
    tri_ids = torch.arange(t, dtype=torch.int32, device=dev)[:, None] \
        .expand(t, expand)
    tri_ids = pad_flat(tri_ids, t)
    tri_ids = torch.where(keys >= dead, torch.full_like(tri_ids, t), tri_ids)

    shift = ybits + zbits
    if has_z or has_y:
        # Within-bin order: key = bin << (ybits + zbits) | y-bucket <<
        # zbits | quantized zmin.
        low = torch.zeros_like(tri_ids)
        if has_y:
            # First covered strip RELATIVE to the pair's own tile (dense
            # pairs only; supertile/global pairs take bucket 0).
            yb_tri = torch.clamp(torch.floor(bbox[:, 1] / ysort_sub_rows),
                                 0.0, 4095.0)
            tile_base = (ty0[:, None] + ey + y0f) * float(n_sub)
            yb = torch.clamp(yb_tri[:, None] - tile_base, 0.0,
                             float(n_sub - 1))
            yb = torch.where((e < ncov[:, None]) & small[:, None], yb,
                             torch.zeros_like(yb))
            low = pad_flat(yb, 0.0).to(torch.int32) << zbits
        if has_z:
            zq = torch.clamp(
                torch.floor(setup.zmin * zscale), 0.0, zscale
            ).to(torch.int32)
            zq = pad_flat(zq[:, None].expand(t, expand), 0)
            low = low | zq
        keys_i = (keys.to(torch.int32) << shift) | low
    else:
        keys_i = keys.to(torch.int32)

    skey, order = torch.sort(keys_i, stable=True)
    stri = tri_ids[order]

    # Live-pair capacity: dead pairs sort LAST, so the live pairs occupy a
    # prefix of the sorted stream - slicing to ``max_pairs`` makes the
    # O(P) record gather track the POST-CULL pair count. Overflow (live
    # pairs beyond the cap) is counted; ranges clamp automatically because
    # searchsorted runs on the sliced keys.
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if max_pairs is not None and max_pairs < skey.shape[0]:
        cap = max(128, (max_pairs // 128) * 128)
        live_end = torch.searchsorted(
            skey,
            torch.tensor([(n_tiles + n_super + 1) << shift],
                         dtype=torch.int32, device=dev),
        )[0].to(torch.int32)
        overflow = torch.clamp_min(live_end - cap, 0)
        skey = skey[:cap].contiguous()
        stri = stri[:cap]

    # Per-bin offsets via binary search over the SORTED keys. Bin b's keys
    # occupy [b << k, (b+1) << k), k = ybits + zbits.
    off = torch.searchsorted(
        skey, torch.arange(n_bins, dtype=torch.int32, device=dev) << shift,
    ).to(torch.int32)
    if align:
        stri, starts, ends, sstarts, sends, gbounds = _align_bins(
            stri, off, n_tiles, n_super, t)
    else:
        starts = off[:n_tiles]
        ends = off[1 : n_tiles + 1]
        sstarts = off[n_tiles : n_tiles + n_super]
        sends = off[n_tiles + 1 : n_tiles + n_super + 1]
        gbounds = off[n_tiles + n_super : n_tiles + n_super + 2]

    records = rec16[stri.long()]  # (P, rec_w)
    return PairedTriangles(
        records=records,
        pair_tri=stri.contiguous(),
        starts=starts.contiguous(),
        ends=ends.contiguous(),
        sstarts=sstarts.contiguous(),
        sends=sends.contiguous(),
        gbounds=gbounds.contiguous(),
        overflow=overflow,
    )


def _align_bins(stri, off, n_tiles: int, n_super: int, dead_id: int):
    """Reposition every walked bin (dense, supertile, global) to a 128-pair
    boundary, as the JAX package's ``build_pairs(align=True)``: output
    position j belongs to the last bin starting at or before it and reads
    source ``off[b] + (j - aoff[b])``; positions past the bin's length hold
    ``dead_id``. Returns (stri, starts, ends, sstarts, sends, gbounds)."""
    dev = stri.device
    n_walk = n_tiles + n_super + 1
    p0 = stri.shape[0]
    lens = off[1 : n_walk + 1] - off[:n_walk]
    aoff = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(torch.div(lens + 127, 128, rounding_mode="floor") * 128,
                     0, dtype=torch.int32)])
    total = p0 + 128 * n_walk  # a static bound, a multiple of 128
    j = torch.arange(total, dtype=torch.int32, device=dev)
    # Bin of each position: the count of bin starts at or before it, less
    # one (coincident starts of empty bins resolve to the last of them).
    ind = torch.zeros((total,), dtype=torch.int32, device=dev)
    ind.index_add_(0, aoff[:n_walk].long(),
                   torch.ones((n_walk,), dtype=torch.int32, device=dev))
    b_j = torch.clamp(torch.cumsum(ind, 0, dtype=torch.int32) - 1, 0,
                      n_walk - 1).long()
    rel = j - aoff[b_j]
    src = torch.clamp_max(off[b_j] + rel, p0 - 1)
    stri = torch.where(rel < lens[b_j], stri[src.long()],
                       torch.full_like(rel, dead_id))
    starts = aoff[:n_tiles]
    sstarts = aoff[n_tiles : n_tiles + n_super]
    g0 = aoff[n_tiles + n_super]
    return (stri, starts, starts + lens[:n_tiles], sstarts,
            sstarts + lens[n_tiles : n_tiles + n_super],
            torch.stack([g0, g0 + lens[n_tiles + n_super]]))


# ------------------------------------------------------------ plain version


def _tile_pair_seq(pairs: PairedTriangles, n_ty: int, n_tx: int,
                   tile_h: int, tile_w: int):
    """Expand the three range levels to one flat (tile, pair) list:
    (tiles, pair ids, seq) with seq the entry's place in its tile's
    sequence (dense, then supertile, then global pairs), the order the
    kernels walk."""
    dev = pairs.records.device
    n_tiles = n_ty * n_tx
    super_h, super_w = _super_h(tile_h), _super_w(tile_w)
    n_sx = -(-n_tx // super_w)
    i64 = torch.int64

    def ranges_to_list(starts, ends):
        # (bin, pair, place in the range) for every pair of every
        # [starts[b], ends[b]).
        lens = (ends - starts).to(i64).clamp_min(0)
        bins = torch.repeat_interleave(
            torch.arange(starts.shape[0], device=dev), lens)
        first = torch.cumsum(lens, 0) - lens
        within = torch.arange(bins.shape[0], device=dev) - first[bins]
        return bins, starts.to(i64)[bins] + within, within

    d_tile, d_pair, d_seq = ranges_to_list(pairs.starts, pairs.ends)
    s_bin, s_pair, s_within = ranges_to_list(pairs.sstarts, pairs.sends)
    # Supertile s covers tiles (sy*super_h + dy, sx*super_w + dx).
    dy = torch.arange(super_h, device=dev).repeat_interleave(super_w)
    dx = torch.arange(super_w, device=dev).repeat(super_h)
    t_y = (s_bin // n_sx)[:, None] * super_h + dy[None, :]
    t_x = (s_bin % n_sx)[:, None] * super_w + dx[None, :]
    ok = (t_y < n_ty) & (t_x < n_tx)
    s_tile = (t_y * n_tx + t_x)[ok]
    s_pair = s_pair[:, None].expand(-1, dy.shape[0])[ok]
    s_within = s_within[:, None].expand(-1, dy.shape[0])[ok]
    g0, g1 = int(pairs.gbounds[0]), int(pairs.gbounds[1])
    g_pairs = torch.arange(g0, max(g1, g0), device=dev)
    g_tile = torch.arange(n_tiles, device=dev).repeat_interleave(
        g_pairs.shape[0])
    g_pair = g_pairs.repeat(n_tiles)
    # Lengths of each tile's dense and supertile ranges.
    tile = torch.arange(n_tiles, device=dev)
    tile_super = (tile // n_tx // super_h) * n_sx + (tile % n_tx) // super_w
    len_d = (pairs.ends - pairs.starts).to(i64).clamp_min(0)
    len_s = (pairs.sends - pairs.sstarts).to(i64).clamp_min(0)[tile_super]
    seq = torch.cat([d_seq, len_d[s_tile] + s_within,
                     (len_d + len_s)[g_tile] + (g_pair - g0)])
    return (torch.cat([d_tile, s_tile, g_tile]),
            torch.cat([d_pair, s_pair, g_pair]), seq)


def _tile_pair_list(pairs: PairedTriangles, n_ty: int, n_tx: int,
                    tile_h: int, tile_w: int):
    """(tiles, pair ids) of ``_tile_pair_seq``."""
    return _tile_pair_seq(pairs, n_ty, n_tx, tile_h, tile_w)[:2]


def _candidates(pairs: PairedTriangles, tiles, pids, n_tx: int,
                tile_h: int, tile_w: int, lx, ly, y0: int = 0):
    """Depth of each (tile, pair) entry at each of the tile's pixels
    (lx, ly), +inf where the pair does not cover it, with the kernels'
    arithmetic in their operation order: (cand (C, TP), gx, gy), gx and gy
    band-local; the pixel centres lie ``y0`` viewport rows lower."""
    r = pairs.records[pids][:, :12]  # (C, 12)
    gx = (tiles % n_tx)[:, None] * tile_w + lx[None, :]  # (C, TP)
    gy = (tiles // n_tx)[:, None] * tile_h + ly[None, :]
    px = gx.to(torch.float32) + 0.5
    py = (gy + y0).to(torch.float32) + 0.5

    def c(i):
        return r[:, i : i + 1]

    e0 = edge_value(c(0), c(1), c(2), px, py)
    e1 = edge_value(c(3), c(4), c(5), px, py)
    e2 = edge_value(c(6), c(7), c(8), px, py)
    d = plane_depth(e0, e1, e2, c(9), c(10), c(11))
    esum = e0 + e1 + e2
    emin = torch.minimum(torch.minimum(e0, e1), e2)
    inside = (emin >= 0.0) & (esum > 0.0) & (d >= 0.0) & (d <= 1.0)
    return torch.where(inside, d, torch.full_like(d, float("inf"))), gx, gy


def _plain_visibility(pairs: PairedTriangles, height: int, width: int,
                      init_depth, tile_h: int, tile_w: int,
                      want_id: bool = True, chunk_elems: int = 1 << 22,
                      entries=None, sub_rows: int = 8, y_row: int = -1,
                      y0_tiles: int = 0):
    """(depth (H, W), winner pair id (H, W) int64 or None) by the kernel's
    rule: minimum depth; lowest pair id among minimum-depth candidates;
    ``init_depth`` wins ties with id -1. Candidates are evaluated with the
    kernel's arithmetic in the kernel's operation order. ``entries``: the
    (tiles, pair ids) to walk, by default every tile's whole sequence.
    With ``y_row`` >= 0 a pixel tests only the pairs its warp of the strip
    walk tests (``strip_walk_hits``): the walk's skips are exact for every
    pixel inside a pair's bbox, but a sliver triangle whose edge values all
    lie within rounding of zero can pass the coverage test outside it, and
    the kernels and this version must agree there too. ``y0_tiles``: the
    buffers are the band of viewport tile rows [y0_tiles, y0_tiles +
    height / tile_h), as the kernels take it."""
    dev = pairs.records.device
    y0 = int(y0_tiles) * tile_h
    assert height % tile_h == 0 and width % tile_w == 0, (
        height, width, tile_h, tile_w)
    n_ty, n_tx = height // tile_h, width // tile_w
    assert pairs.starts.shape == (n_ty * n_tx,), (
        pairs.starts.shape, n_ty * n_tx)
    tiles, pids = entries if entries is not None else _tile_pair_list(
        pairs, n_ty, n_tx, tile_h, tile_w)
    tp = tile_h * tile_w
    loc = torch.arange(tp, device=dev)
    lx, ly = loc % tile_w, loc // tile_w
    walk_hit = None
    if y_row >= 0:
        walk_hit = _walk_hits(pairs, tiles, pids, width, tile_h, tile_w,
                              sub_rows, y_row, y0)
        warp = loc // (32 * _pixels_per_thread(tile_h, tile_w))
    if init_depth is None:
        init = torch.ones((height * width,), dtype=torch.float32, device=dev)
    else:
        init = init_depth.to(torch.float32).reshape(-1)
    inf = float("inf")
    n_chunk = max(1, chunk_elems // tp)

    def candidates(sl):
        cand, gx, gy = _candidates(pairs, tiles[sl], pids[sl], n_tx, tile_h,
                                   tile_w, lx, ly, y0)
        if walk_hit is not None:
            cand = torch.where(walk_hit[sl][:, warp], cand,
                               torch.full_like(cand, inf))
        return cand.reshape(-1), (gy * width + gx).reshape(-1)

    n = tiles.shape[0]
    if not want_id:
        depth = init.clone()
        for s in range(0, n, n_chunk):
            cand, pix = candidates(slice(s, s + n_chunk))
            depth.scatter_reduce_(0, pix, cand, "amin", include_self=True)
        # The minimum's bits are the winner's but for the sign of a zero
        # (a scatter minimum leaves it open): a zero takes the winner's
        # sign from the keyed pass below.
        if not bool((depth == 0).any()):
            return depth.reshape(height, width), None
    # One pass over 64-bit keys (kernel pair_raster's merge key): the
    # order-preserving depth bits (-0.0 as +0.0) << 32 | (pair id + 1) << 1
    # | sign bit, init_depth keyed as order 0. The minimum is the first
    # minimum-depth candidate in pair order, its sign included; init wins
    # ties.
    key = _merge_key(init, 0)
    for s in range(0, n, n_chunk):
        sl = slice(s, s + n_chunk)
        cand, pix = candidates(sl)
        ids = pids[sl][:, None].expand(-1, tp).reshape(-1)
        key.scatter_reduce_(0, pix, _merge_key(cand, ids + 1), "amin",
                            include_self=True)
    order = (key & 0xFFFFFFFF) >> 1
    won = order > 0
    depth = torch.where(won, _key_depth(key), init)
    pid = torch.where(won, order - 1, torch.full_like(key, -1))
    return depth.reshape(height, width), (pid.reshape(height, width)
                                          if want_id else None)


def _map_tid(pairs: PairedTriangles, pid):
    return torch.where(
        pid >= 0, pairs.pair_tri[pid.clamp_min(0)],
        torch.full((), -1, dtype=torch.int32, device=pid.device))


def _early_out_row(pairs: PairedTriangles, early_out: bool, z_row: int,
                   eo_stride: int, y_row: int) -> int:
    """The z bucket column the occlusion early-out reads, or -1 when it is
    off: it needs ``early_out``, a z column and no strip-span column (the
    JAX package forces it off under ``raster_ysort``: y-bucketed bins are
    not sorted by z)."""
    if not (early_out and z_row >= 0 and y_row < 0):
        return -1
    if z_row >= pairs.records.shape[1]:
        raise ValueError(f"z_row {z_row} is not a column of records "
                         f"{tuple(pairs.records.shape)}")
    if eo_stride < 1:
        raise ValueError(f"eo_stride must be positive, got {eo_stride}")
    return z_row


def early_out_walk(pairs: PairedTriangles, height: int, width: int,
                   tile_h: int, tile_w: int, z_row: int, eo_stride: int,
                   init_depth=None, n_parts: int = 1, min_chunks: int = 1,
                   chunk: int = 64, chunk_elems: int = 1 << 22,
                   y0_tiles: int = 0):
    """The occlusion early-out of the strip walk (``csrc/strip_walk.cuh``)
    in PyTorch: which (tile, pair) entries of ``_tile_pair_list`` a block
    walks, and how many it skips.

    Blocks are those of the kernel: a tile's sequence (dense, supertile,
    then global range) cut into chunks of ``chunk`` pairs and into parts
    of max(ceil(n / n_parts), min_chunks) chunks (``split_parts_of``;
    n_parts = 1 is one block a tile). After the ``eo_stride``-th, 2
    ``eo_stride``-th, ... chunk of its part, a block takes the maximum over
    its tile's pixels of min(acc, init) and, for each range with pairs in
    that chunk and not stopped yet, their largest z bucket (record column
    ``z_row``); a range whose bucket lies strictly above that maximum is
    stopped, and its later pairs in the part are skipped. ``y0_tiles``: the
    row band, as ``rasterize_pairs`` takes it. Returns (tiles, pair ids,
    keep (N,) bool, skipped count as a Python int)."""
    dev = pairs.records.device
    i64 = torch.int64
    n_ty, n_tx = height // tile_h, width // tile_w
    n_tiles = n_ty * n_tx
    tiles, pids, seq = _tile_pair_seq(pairs, n_ty, n_tx, tile_h, tile_w)
    super_h, super_w = _super_h(tile_h), _super_w(tile_w)
    n_sx = -(-n_tx // super_w)
    t_super = (tiles // n_tx // super_h) * n_sx + (tiles % n_tx) // super_w
    len_d = (pairs.ends - pairs.starts).to(i64).clamp_min(0)[tiles]
    len_s = (pairs.sends - pairs.sstarts).to(i64).clamp_min(0)[t_super]
    rng = (seq >= len_d).to(i64) + (seq >= len_d + len_s).to(i64)
    n_chunks = -(-torch.bincount(tiles, minlength=n_tiles) // chunk)
    per = torch.clamp_min(-(-n_chunks // n_parts), min_chunks)[tiles]
    ch = seq // chunk
    part = ch // per
    local = ch - part * per
    block = tiles * n_parts + part
    rnd = local // eo_stride
    at_test = (local % eo_stride) == eo_stride - 1
    z = pairs.records[pids, z_row]

    tp = tile_h * tile_w
    loc = torch.arange(tp, device=dev)
    lx, ly = loc % tile_w, loc // tile_w
    init = (torch.ones((height, width), dtype=torch.float32, device=dev)
            if init_depth is None else init_depth.to(torch.float32))
    init_t = init.reshape(n_ty, tile_h, n_tx, tile_w).permute(
        0, 2, 1, 3).reshape(n_tiles, tp)
    best = init_t.repeat_interleave(n_parts, 0).reshape(-1)
    n_blocks = n_tiles * n_parts
    stopped = torch.zeros((n_blocks * 3,), dtype=torch.bool, device=dev)
    keep = torch.ones(tiles.shape, dtype=torch.bool, device=dev)
    n_chunk = max(1, chunk_elems // tp)
    order = torch.argsort(rnd, stable=True)
    counts = torch.bincount(rnd).tolist() if rnd.numel() else []
    first = 0
    for n_k in counts:
        idx = order[first:first + n_k]
        first += n_k
        gone = stopped[block[idx] * 3 + rng[idx]]
        keep[idx[gone]] = False
        act = idx[~gone]
        for s0 in range(0, act.shape[0], n_chunk):
            a = act[s0:s0 + n_chunk]
            cand, _, _ = _candidates(pairs, tiles[a], pids[a], n_tx, tile_h,
                                     tile_w, lx, ly, int(y0_tiles) * tile_h)
            best.scatter_reduce_(
                0, (block[a][:, None] * tp + loc[None, :]).reshape(-1),
                cand.reshape(-1), "amin", include_self=True)
        t_sel = act[at_test[act]]
        if t_sel.numel():
            zb = torch.full((n_blocks * 3,), float("-inf"),
                            dtype=torch.float32, device=dev)
            zb.scatter_reduce_(0, block[t_sel] * 3 + rng[t_sel], z[t_sel],
                               "amax", include_self=True)
            eff = best.reshape(n_blocks, tp).amax(1)
            stopped |= zb > eff.repeat_interleave(3)
    return tiles, pids, keep, int((~keep).sum())


def rasterize_pairs_plain(pairs: PairedTriangles, height: int, width: int,
                          init_depth=None, tile_h: int = 32,
                          tile_w: int = 128, depth_only: bool = False,
                          sub_rows: int = 8, y_row: int = -1,
                          early_out: bool = False, z_row: int = -1,
                          eo_stride: int = 4, eo_skipped=None,
                          split_parts: Optional[int] = None,
                          y0_tiles: int = 0):
    """Plain PyTorch version of ``rasterize_pairs`` (any device). With the
    early-out, the pairs the kernel's blocks skip (``early_out_walk``, the
    blocks of the split at ``split_parts``, by default ``SPLIT_PARTS`` as
    the kernel reads it) are left out and their count added to
    ``eo_skipped``."""
    entries = None
    z_eo = _early_out_row(pairs, early_out, z_row, eo_stride, y_row)
    if z_eo >= 0:
        parts = SPLIT_PARTS if split_parts is None else split_parts
        tiles, pids, keep, n_skip = early_out_walk(
            pairs, height, width, tile_h, tile_w, z_eo, eo_stride,
            init_depth, n_parts=parts,
            min_chunks=SPLIT_MIN_CHUNKS if parts > 1 else 1,
            chunk=SPLIT_CHUNK, y0_tiles=y0_tiles)
        entries = (tiles[keep], pids[keep])
        if eo_skipped is not None:
            eo_skipped += n_skip
    depth, pid = _plain_visibility(pairs, height, width, init_depth, tile_h,
                                   tile_w, want_id=not depth_only,
                                   entries=entries, sub_rows=sub_rows,
                                   y_row=y_row, y0_tiles=y0_tiles)
    if depth_only:
        return depth
    return depth, _map_tid(pairs, pid)


# Kernel pair_raster's split of crowded tiles: up to SPLIT_PARTS blocks a
# tile, each walking a contiguous part of at least SPLIT_MIN_CHUNKS chunks
# of SPLIT_CHUNK pairs (the strip walk's staging chunk). rasterize_pairs
# reads SPLIT_PARTS at each call; 1 walks every tile in one block.
SPLIT_PARTS = 8
SPLIT_MIN_CHUNKS = 2
SPLIT_CHUNK = 64


def split_parts_of(pairs: PairedTriangles, height: int, width: int,
                   tile_h: int, tile_w: int, split_parts: int = SPLIT_PARTS,
                   split_min_chunks: int = SPLIT_MIN_CHUNKS,
                   chunk: int = SPLIT_CHUNK):
    """Which block of kernel ``pair_raster`` walks each (tile, pair) entry:
    (tiles, pair ids, part, split) in ``_tile_pair_list`` order, with part
    the entry's part of its tile's sequence and split (n_tiles,) bool the
    tiles whose sequence spans more than one part. A tile of n chunks is
    cut into parts of max(ceil(n / split_parts), split_min_chunks)
    chunks."""
    n_ty, n_tx = height // tile_h, width // tile_w
    tiles, pids, seq = _tile_pair_seq(pairs, n_ty, n_tx, tile_h, tile_w)
    total = torch.bincount(tiles, minlength=n_ty * n_tx)
    n_chunks = -(-total // chunk)
    per = torch.clamp_min(-(-n_chunks // split_parts), split_min_chunks)
    part = (seq // chunk) // per[tiles]
    return tiles, pids, part, per < n_chunks


def _ordered(depth: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order of the float32 values, -0.0 taken as +0.0
    (the kernel's order-preserving bits, as signed integers)."""
    b = (depth + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _merge_key(depth: torch.Tensor, order1) -> torch.Tensor:
    """Kernel pair_raster's merge key of ``depth`` found at order + 1
    (pair id, or part): ordered depth << 32 | order + 1 << 1 | sign bit."""
    return ((_ordered(depth) << 32) | (order1 << 1)
            | torch.signbit(depth).to(torch.int64))


def _key_depth(key: torch.Tensor) -> torch.Tensor:
    """The depth of a merge key, the sign of a zero restored."""
    h = key >> 32
    b = torch.where(h < 0, h ^ 0x7FFFFFFF, h)
    d = b.to(torch.int32).view(torch.float32)
    return torch.where((key & 1) == 1, -d, d)


def rasterize_pairs_split_plain(pairs: PairedTriangles, height: int,
                                width: int, init_depth=None,
                                tile_h: int = 32, tile_w: int = 128,
                                depth_only: bool = False,
                                split_parts: int = SPLIT_PARTS,
                                split_min_chunks: int = SPLIT_MIN_CHUNKS,
                                chunk: int = SPLIT_CHUNK,
                                sub_rows: int = 8, y_row: int = -1,
                                y0_tiles: int = 0):
    """Kernel ``pair_raster``'s split in PyTorch: the plain walk over each
    part of each tile's sequence (``split_parts_of``), merged as the kernel
    merges it. A tile of one part keeps that part's result. Split tiles take
    the minimum over their parts of the 64-bit key (depth bits, -0.0
    folded into +0.0) << 32 | (pair id + 1) << 1 | sign bit, with
    ``init_depth`` keyed as order 0; depth only, the part + 1 takes the
    pair id's place (parts follow pair order). Equal to
    ``rasterize_pairs_plain`` bit for bit by construction (the first
    minimum-depth candidate in pair order, its sign included, as ``d <
    best`` keeps it; init wins ties), which the tests check."""
    dev = pairs.records.device
    tiles, pids, part, split = split_parts_of(
        pairs, height, width, tile_h, tile_w, split_parts, split_min_chunks,
        chunk)
    n_tx = width // tile_w
    gy, gx = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    split_px = split[(gy // tile_h) * n_tx + gx // tile_w]
    init = (torch.ones((height, width), dtype=torch.float32, device=dev)
            if init_depth is None else init_depth.to(torch.float32))
    big = torch.iinfo(torch.int64).max
    key = torch.full((height, width), big, dtype=torch.int64, device=dev)
    first = None
    for p in range(max(split_parts, 1)):
        sel = part == p
        depth_p, pid_p = _plain_visibility(
            pairs, height, width, init, tile_h, tile_w,
            want_id=not depth_only, entries=(tiles[sel], pids[sel]),
            sub_rows=sub_rows, y_row=y_row, y0_tiles=y0_tiles)
        if first is None:
            first = (depth_p, pid_p)
        if depth_only:
            # depth_p is init where the part has no candidate.
            key = torch.minimum(key, _merge_key(depth_p, p + 1))
        else:
            key = torch.minimum(key, torch.where(
                pid_p >= 0, _merge_key(depth_p, pid_p + 1),
                torch.full_like(key, big)))
    wins = key < (_ordered(init) << 32)
    depth = torch.where(split_px & wins, _key_depth(key),
                        torch.where(split_px, init, first[0]))
    if depth_only:
        return depth
    pid = torch.where(wins, (key & 0xFFFFFFFF) >> 1,
                      torch.full_like(key, 0)) - 1
    pid = torch.where(split_px, pid, first[1])
    return depth, _map_tid(pairs, pid)


# Output attribute planes of the fused kernel, channel-major (C, H, W):
#   0 covered*(1 + min barycentric), 1 combo, 2-3 uv, 4 lod, 5-7 vertex
#   color, 8-10 world pos, 11-13 interpolated world normal, 14-15 duv/dx,
#   16-17 duv/dy, 18-20 dpos/dx, 21-23 dpos/dy.
ATTR_CH = 24


def fused_extra_width(need_uv: bool = True, need_combo: bool = True) -> int:
    """Width of the fused extra payload under the static elision flags:
    [combo id] + 3 corners x ([uv2], color3, world-pos3, world-normal3)."""
    corner_w = 11 if need_uv else 9
    return (1 if need_combo else 0) + 3 * corner_w


def rasterize_pairs_fused_plain(pairs: PairedTriangles, height: int,
                                width: int, init_depth=None,
                                tile_h: int = 32, tile_w: int = 128,
                                texture_size: int = 256,
                                need_uv: bool = True, has_combo: bool = True,
                                combo_const: float = 0.0,
                                sub_rows: int = 8, y_row: int = -1,
                                early_out: bool = False, z_row: int = -1,
                                eo_stride: int = 4, eo_skipped=None,
                                y0_tiles: int = 0):
    """Plain PyTorch version of ``rasterize_pairs_fused`` (any device):
    the plain visibility pass, one gather of the winner's record row per
    pixel, and the kernel's epilogue in the kernel's operation order. With
    the early-out, the pairs the kernel skips (``early_out_walk``, one
    block a tile) are left out and their count added to ``eo_skipped``."""
    entries = None
    z_eo = _early_out_row(pairs, early_out, z_row, eo_stride, y_row)
    if z_eo >= 0:
        tiles, pids, keep, n_skip = early_out_walk(
            pairs, height, width, tile_h, tile_w, z_eo, eo_stride,
            init_depth, chunk=SPLIT_CHUNK, y0_tiles=y0_tiles)
        entries = (tiles[keep], pids[keep])
        if eo_skipped is not None:
            eo_skipped += n_skip
    depth, pid = _plain_visibility(pairs, height, width, init_depth, tile_h,
                                   tile_w, entries=entries,
                                   sub_rows=sub_rows, y_row=y_row,
                                   y0_tiles=y0_tiles)
    planes = fused_planes_plain(
        pairs.records[pid.clamp_min(0)], pid >= 0, int(y0_tiles) * tile_h,
        texture_size, need_uv, has_combo, combo_const)
    return depth, _map_tid(pairs, pid), planes


def fused_planes_plain(rec: torch.Tensor, covered: torch.Tensor, y0: int = 0,
                       texture_size: int = 256, need_uv: bool = True,
                       has_combo: bool = True, combo_const: float = 0.0):
    """The fused kernel's epilogue in PyTorch, in its operation order: the
    (ATTR_CH, H, W) planes from each pixel's winner record row ``rec``
    (H, W, rec_w) where ``covered``, the pixel centres ``y0`` viewport rows
    below the buffer's first row."""
    height, width = covered.shape
    dev = rec.device
    rec = torch.where(covered[..., None], rec, torch.zeros_like(rec))
    gy, gx = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    px = gx.to(torch.float32) + 0.5
    py = (gy + y0).to(torch.float32) + 0.5

    def A(c):
        return rec[..., c]

    e0 = A(0) * px + A(1) * py + A(2)
    e1 = A(3) * px + A(4) * py + A(5)
    e2 = A(6) * px + A(7) * py + A(8)
    esum = e0 + e1 + e2
    one = torch.ones_like(esum)
    zero = torch.zeros_like(esum)
    inv = 1.0 / torch.where(torch.abs(esum) > 1e-20, esum, one)
    inv = torch.where(covered, inv, zero)
    b0, b1, b2 = e0 * inv, e1 * inv, e2 * inv

    corner_w = 11 if need_uv else 9
    base_r = 12 + (1 if has_combo else 0)
    off_col = 2 if need_uv else 0
    off_pos = off_col + 3
    off_nrm = off_pos + 3

    def interp(off, w0, w1, w2):
        return (w0 * A(base_r + off) + w1 * A(base_r + corner_w + off)
                + w2 * A(base_r + 2 * corner_w + off))

    planes = [zero] * ATTR_CH
    bmin = torch.minimum(torch.minimum(b0, b1), b2)
    planes[0] = covered.to(torch.float32) * (1.0 + bmin)
    planes[1] = A(12) if has_combo else (zero + combo_const)
    if need_uv:
        sax = A(0) + A(3) + A(6)
        say = A(1) + A(4) + A(7)
        d0x = (A(0) - b0 * sax) * inv
        d1x = (A(3) - b1 * sax) * inv
        d2x = (A(6) - b2 * sax) * inv
        d0y = (A(1) - b0 * say) * inv
        d1y = (A(4) - b1 * say) * inv
        d2y = (A(7) - b2 * say) * inv
        duvdx0 = interp(0, d0x, d1x, d2x)
        duvdx1 = interp(1, d0x, d1x, d2x)
        duvdy0 = interp(0, d0y, d1y, d2y)
        duvdy1 = interp(1, d0y, d1y, d2y)
        ts = float(texture_size)
        foot = torch.maximum(
            duvdx0 * duvdx0 + duvdx1 * duvdx1,
            duvdy0 * duvdy0 + duvdy1 * duvdy1,
        )
        lod = torch.clamp_min(
            0.5 * torch.log2(torch.clamp_min(foot * (ts * ts), 1e-12)), 0.0)
        planes[2] = interp(0, b0, b1, b2)
        planes[3] = interp(1, b0, b1, b2)
        planes[4] = lod
        planes[14], planes[15] = duvdx0, duvdx1
        planes[16], planes[17] = duvdy0, duvdy1
        for c in range(3):  # dpos/dx, dpos/dy
            planes[18 + c] = interp(off_pos + c, d0x, d1x, d2x)
            planes[21 + c] = interp(off_pos + c, d0y, d1y, d2y)
    for c in range(3):
        planes[5 + c] = interp(off_col + c, b0, b1, b2)  # vertex color
        planes[8 + c] = interp(off_pos + c, b0, b1, b2)  # world pos
        planes[11 + c] = interp(off_nrm + c, b0, b1, b2)  # world normal
    return torch.stack(planes, dim=0)


def _pixels_per_thread(tile_h: int, tile_w: int) -> int:
    """Pixels per thread of the raster kernels (256 threads a tile),
    rounded up to a power of two, as ``zk::pixels_per_thread``."""
    need = -(-(tile_h * tile_w) // 256)
    return 1 << max(0, (need - 1).bit_length())


def strip_walk_hits(pairs: PairedTriangles, height: int, width: int,
                    tile_h: int, tile_w: int, sub_rows: int = 8,
                    y_row: int = -1, y0_tiles: int = 0):
    """Which pairs the strip walk of kernels ``pair_raster`` and
    ``pair_raster_fused`` tests, per warp: (tiles,
    pair ids, hits) with one row per (tile, pair) of the tile's dense,
    supertile and global ranges and hits an (N, 8) bool of the 8 warps.

    Warp w of a tile owns the linear tile pixels [w*32*NPP, (w+1)*32*NPP);
    a warp that owns no pixel tests nothing. With ``y_row`` < 0 the others
    test every pair. Otherwise a warp skips a pair whose packed strip span
    misses the warp's rows, or one of whose edge functions is below
    -1e-5 * (|a| x1 + |b| y1 + |c|) at the corner of the warp's pixel-centre
    rectangle (all tile columns x the warp's rows) that its signs pick: the
    kernel's test in the kernel's fp32 operation order. In a row band
    (``y0_tiles``) the warp's rows, which the span and the rectangle are
    tested against, are viewport rows."""
    tiles, pids = _tile_pair_list(pairs, height // tile_h, width // tile_w,
                                  tile_h, tile_w)
    return tiles, pids, _walk_hits(pairs, tiles, pids, width, tile_h,
                                   tile_w, sub_rows, y_row,
                                   int(y0_tiles) * tile_h)


def _walk_hits(pairs: PairedTriangles, tiles, pids, width: int, tile_h: int,
               tile_w: int, sub_rows: int, y_row: int,
               y0: int = 0) -> torch.Tensor:
    """The (N, 8) warp hits of ``strip_walk_hits`` for given entries, the
    band starting ``y0`` viewport rows down."""
    n_tx = width // tile_w
    dev = pairs.records.device
    f32 = torch.float32
    run = 32 * _pixels_per_thread(tile_h, tile_w)
    tile_px = tile_h * tile_w
    first = torch.arange(8, device=dev) * run
    owns = first < tile_px
    last = torch.clamp(first + run, max=tile_px) - 1
    if y_row < 0:
        return owns[None, :].expand(tiles.shape[0], -1)
    ty = (tiles // n_tx)[:, None] * tile_h + y0
    r0 = (ty + (first // tile_w)[None, :]).to(f32)
    r1 = (ty + (torch.maximum(last, first) // tile_w)[None, :]).to(f32)
    rec = pairs.records[pids]
    v = rec[:, y_row : y_row + 1]
    y1 = torch.floor(v * (1.0 / 4096.0))
    y0 = v - y1 * 4096.0
    hit = ((y0 * sub_rows <= r1) & ((y1 + 1.0) * sub_rows - 1.0 >= r0)
           & owns[None, :])
    rx0 = ((tiles % n_tx) * tile_w).to(f32)[:, None] + 0.5
    rx1 = ((tiles % n_tx) * tile_w + tile_w - 1).to(f32)[:, None] + 0.5
    ry0, ry1 = r0 + 0.5, r1 + 0.5
    for i in range(3):
        a, b, c = (rec[:, 3 * i + j : 3 * i + j + 1] for j in range(3))
        x = torch.where(a >= 0.0, rx1, rx0)
        y = torch.where(b >= 0.0, ry1, ry0)
        e = x * a + y * b + c
        s = torch.abs(a) * rx1 + torch.abs(b) * ry1 + torch.abs(c)
        hit = hit & ~(e < -1e-5 * s)
    return hit


def strip_walk_tests(pairs: PairedTriangles, height: int, width: int,
                     tile_h: int, tile_w: int, sub_rows: int = 8,
                     y_row: int = -1, y0_tiles: int = 0) -> torch.Tensor:
    """(pixel, pair) tests the strip walk (kernels ``pair_raster``,
    ``pair_raster_fused``) makes on this pair stream, per tile and warp: an
    (n_tiles, 8) int64 tensor. A warp tests
    all 32*NPP of its pixel slots against each pair it does not skip
    (``strip_walk_hits``)."""
    tiles, _, hit = strip_walk_hits(pairs, height, width, tile_h, tile_w,
                                    sub_rows, y_row, y0_tiles)
    per = torch.zeros(((height // tile_h) * (width // tile_w), 8),
                      dtype=torch.int64, device=pairs.records.device)
    per.index_add_(0, tiles, hit.to(torch.int64))
    return per * (32 * _pixels_per_thread(tile_h, tile_w))


# ------------------------------------------------------------------ kernels


def _use_kernel(t: torch.Tensor, backend: str) -> bool:
    """Dispatch rule of every wrapper in the package: ``auto`` follows the
    tensor's device, ``cuda`` demands the kernel, ``torch`` the plain
    version."""
    if backend == "torch":
        return False
    if backend == "cuda" and not t.is_cuda:
        raise RuntimeError(
            "backend='cuda' needs tensors on the card; got a CPU tensor")
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return t.is_cuda


def _check(t: torch.Tensor, name: str, dtype, shape=None, dev=None):
    if not t.is_cuda or (dev is not None and t.device != dev):
        raise ValueError(f"{name}: expected a tensor on {dev or 'cuda'}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def _check_pairs(pairs: PairedTriangles, height, width, tile_h, tile_w,
                 min_rec_w, init_depth):
    if height % tile_h or width % tile_w:
        raise ValueError(
            f"frame {height}x{width} is not a multiple of the tile "
            f"{tile_h}x{tile_w}; pad first")
    if tile_h * tile_w > 16 * 256:
        raise ValueError(
            f"tile {tile_h}x{tile_w} exceeds the kernel's 4096-pixel tile")
    n_tx, n_ty = width // tile_w, height // tile_h
    super_h, super_w = _super_h(tile_h), _super_w(tile_w)
    n_sx = -(-n_tx // super_w)
    n_super = n_sx * -(-n_ty // super_h)
    dev = pairs.records.device
    if pairs.records.ndim != 2 or pairs.records.shape[1] < min_rec_w:
        raise ValueError(
            f"records: expected (P, >= {min_rec_w}), got "
            f"{tuple(pairs.records.shape)}")
    p = pairs.records.shape[0]
    i32 = torch.int32
    ptrs = [
        _check(pairs.records, "records", torch.float32, dev=dev),
        pairs.records.shape[1],
        _check(pairs.starts, "starts", i32, (n_ty * n_tx,), dev),
        _check(pairs.ends, "ends", i32, (n_ty * n_tx,), dev),
        _check(pairs.sstarts, "sstarts", i32, (n_super,), dev),
        _check(pairs.sends, "sends", i32, (n_super,), dev),
        _check(pairs.gbounds, "gbounds", i32, (2,), dev),
        _check(pairs.pair_tri, "pair_tri", i32, (p,), dev),
        None if init_depth is None else _check(
            init_depth, "init_depth", torch.float32, (height, width), dev),
    ]
    return ptrs, (n_sx, super_h, super_w)


def _check_span(pairs: PairedTriangles, sub_rows: int, y_row: int):
    if y_row >= pairs.records.shape[1]:
        raise ValueError(f"y_row {y_row} is not a column of records "
                         f"{tuple(pairs.records.shape)}")
    if sub_rows <= 0:
        raise ValueError(f"sub_rows must be positive, got {sub_rows}")


def _check_y0(y0_tiles) -> int:
    """The row band's first tile row as a host int (>= 0)."""
    y0 = int(y0_tiles)
    if y0 < 0:
        raise ValueError(f"y0_tiles must be >= 0, got {y0}")
    return y0


def _check_skipped(eo_skipped: Optional[torch.Tensor], dev):
    """The early-out's skip counter: None, or an int32 tensor of one
    element on ``dev``, to which the kernel adds."""
    if eo_skipped is None:
        return None
    return _check(eo_skipped, "eo_skipped", torch.int32, (1,), dev)


def _check_staged(pairs: PairedTriangles):
    if pairs.records.shape[1] % 4 or pairs.records.data_ptr() % 16:
        raise ValueError("records: the kernel stages 16-byte pieces of each "
                         "row; needs a 16-byte aligned base and a row width "
                         f"that is a multiple of 4, got "
                         f"{tuple(pairs.records.shape)}")


def rasterize_pairs(
    pairs: PairedTriangles,
    height: int,
    width: int,
    init_depth: Optional[torch.Tensor] = None,
    tile_h: int = 32,
    tile_w: int = 128,
    sub_rows: int = 8,
    depth_only: bool = False,
    y_row: int = -1,
    early_out: bool = False,
    z_row: int = -1,
    eo_stride: int = 4,
    eo_skipped: Optional[torch.Tensor] = None,
    y0_tiles: int = 0,
    backend: str = "auto",
):
    """Rasterize an exact pair stream to (depth, triangle-id) buffers.

    Returns (depth, tid) with tid = ORIGINAL triangle ids (-1 uncovered),
    or just depth when ``depth_only``. ``y_row`` >= 0 names the record
    column holding the packed strip span that ``build_pairs(
    ysort_sub_rows=sub_rows)`` appends; the kernel then skips, per warp,
    the pairs that cannot cover the warp's pixels, as kernel
    ``pair_raster_fused`` does (``strip_walk_hits``). The kernel splits a
    crowded tile over up to ``SPLIT_PARTS`` blocks (``split_parts_of``)
    and merges them exactly (``rasterize_pairs_split_plain``).
    ``early_out`` with ``z_row`` >= 0 (the z bucket column of
    ``build_pairs(sort_z=True)``) and no span column: each block stops a
    range once every pixel of its tile lies strictly nearer than the
    range's next z bucket, tested after every ``eo_stride`` chunks of 64
    pairs (``early_out_walk``); the pair visits skipped are added to
    ``eo_skipped``, an int32 tensor of one element, when one is given.
    ``y0_tiles`` > 0 rasterizes a row band: the ``height`` rows from
    viewport row ``y0_tiles * tile_h`` into band-sized buffers, from pairs
    binned for that band (``build_pairs(y0_tiles=)``).
    Tensors on the card go to kernel ``pair_raster``; CPU tensors (or
    ``backend="torch"``) to ``rasterize_pairs_plain``, which tests the
    pairs the walk tests.
    """
    _check_span(pairs, sub_rows, y_row)
    y0_tiles = _check_y0(y0_tiles)
    if not _use_kernel(pairs.records, backend):
        return rasterize_pairs_plain(
            pairs, height, width, init_depth, tile_h, tile_w, depth_only,
            sub_rows, y_row, early_out, z_row, eo_stride, eo_skipped,
            split_parts=SPLIT_PARTS, y0_tiles=y0_tiles)
    z_eo = _early_out_row(pairs, early_out, z_row, eo_stride, y_row)
    ptrs, geom = _check_pairs(pairs, height, width, tile_h, tile_w, 12,
                              init_depth)
    _check_staged(pairs)
    skip_ptr = _check_skipped(eo_skipped, pairs.records.device)
    dev = pairs.records.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tid = None if depth_only else torch.empty(
        (height, width), dtype=torch.int32, device=dev)
    # 64-bit merge keys of the split tiles; the C function fills them
    # before the raster.
    n_parts = SPLIT_PARTS
    keys = None if n_parts == 1 else torch.empty(
        (height, width), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = _build.load().zk_pair_raster(
            *ptrs, depth.data_ptr(),
            None if tid is None else tid.data_ptr(),
            None if keys is None else keys.data_ptr(),
            height, width, tile_h, tile_w, *geom, int(sub_rows), int(y_row),
            y0_tiles, n_parts, SPLIT_MIN_CHUNKS, int(depth_only), z_eo,
            int(eo_stride), skip_ptr,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pair_raster")
    rasterize_pairs.launches += 1
    return depth if depth_only else (depth, tid)


rasterize_pairs.launches = 0


def rasterize_pairs_fused(
    pairs: PairedTriangles,
    height: int,
    width: int,
    init_depth: Optional[torch.Tensor] = None,
    tile_h: int = 32,
    tile_w: int = 128,
    sub_rows: int = 8,
    texture_size: int = 256,
    y_row: int = -1,
    need_uv: bool = True,
    has_combo: bool = True,
    combo_const: float = 0.0,
    early_out: bool = False,
    z_row: int = -1,
    eo_stride: int = 4,
    eo_skipped: Optional[torch.Tensor] = None,
    y0_tiles: int = 0,
    backend: str = "auto",
):
    """Rasterize + interpolate in one kernel.

    ``pairs`` must be built with ``extra`` = (T, fused_extra_width(
    need_uv, has_combo)) fused payload. Returns (depth, tid, attrs) with
    tid = ORIGINAL triangle ids and attrs = (ATTR_CH, height, width)
    float32 planes (uv/lod/duv/dpos planes are zeros when ``need_uv`` is
    off). ``y_row`` >= 0 names the record column holding the packed strip
    span that ``build_pairs(ysort_sub_rows=sub_rows)`` appends; the kernel
    then skips, per warp, the pairs whose span misses the warp's rows or
    one of whose edges excludes the warp's pixels (``strip_walk_hits``).
    ``early_out``, ``z_row``, ``eo_stride``, ``eo_skipped``: the occlusion
    early-out of ``rasterize_pairs``, one block a tile. ``y0_tiles``: the
    row band of ``rasterize_pairs``.
    Tensors on the card go to kernel ``pair_raster_fused``; CPU tensors (or
    ``backend="torch"``) to ``rasterize_pairs_fused_plain``, which tests
    the pairs the walk tests.
    """
    min_w = 12 + fused_extra_width(need_uv, has_combo)
    assert pairs.records.shape[1] >= min_w, (
        pairs.records.shape, need_uv, has_combo)
    _check_span(pairs, sub_rows, y_row)
    y0_tiles = _check_y0(y0_tiles)
    if not _use_kernel(pairs.records, backend):
        return rasterize_pairs_fused_plain(
            pairs, height, width, init_depth, tile_h, tile_w, texture_size,
            need_uv, has_combo, combo_const, sub_rows, y_row, early_out,
            z_row, eo_stride, eo_skipped, y0_tiles=y0_tiles)
    z_eo = _early_out_row(pairs, early_out, z_row, eo_stride, y_row)
    ptrs, geom = _check_pairs(pairs, height, width, tile_h, tile_w, min_w,
                              init_depth)
    _check_staged(pairs)
    skip_ptr = _check_skipped(eo_skipped, pairs.records.device)
    dev = pairs.records.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    attrs = torch.empty((ATTR_CH, height, width), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        code = _build.load().zk_pair_raster_fused(
            *ptrs, depth.data_ptr(), tid.data_ptr(), attrs.data_ptr(),
            height, width, tile_h, tile_w, *geom, int(sub_rows), int(y_row),
            y0_tiles, int(texture_size), int(need_uv), int(has_combo),
            float(combo_const), z_eo, int(eo_stride), skip_ptr,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pair_raster_fused")
    rasterize_pairs_fused.launches += 1
    return depth, tid, attrs


rasterize_pairs_fused.launches = 0
