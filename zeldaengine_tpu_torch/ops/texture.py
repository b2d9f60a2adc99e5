"""Texture storage and sampling.

Replaces the reference's texture factory + samplers
(RHICreateTextureResource ZeldaEngine.cpp:5855, RHIGenerateMipmaps :6348,
RHICreateSampler :6523 - repeat addressing, trilinear mips).

All 2D textures of a pool share one square size and live in a single
**mip atlas** array of shape (N, H, 2W, C). Level 0 occupies x in [0, W);
level k >= 1 occupies x in [W * (2 - 2^(1-k)), ...), y from 0. Mip offsets
are static constants, so a sample at a per-pixel LOD is pure index
arithmetic plus one gather per tap. Cubemaps are 6 consecutive layers in
their own pool. Mip generation is 2x2 box filtering (the practical
equivalent of the reference's repeated vkCmdBlitImage linear-filter chain).

This module holds the NumPy atlas packers (the scene build packs on the
host and uploads once) and the samplers: the plain RGBA atlas (bilinear
at a level, trilinear), the neighborhood-packed atlases (one row fetch a
tap; the mip-pair layout gives a whole trilinear sample in one fetch), the
cubemap tap at a per-pixel lod, and the index and filter halves of the
mip-pair and quad taps that the merged environment tap (``ops/envtap.py``)
runs around its one row fetch. Every sampler is an indexing gather
in PyTorch with the JAX package's operation order, so its results equal
the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def mip_count(size: int) -> int:
    return int(size).bit_length()


def mip_offset_x(level: int, base: int) -> int:
    """X offset of a mip level inside the (H, 2W) atlas."""
    if level == 0:
        return 0
    return int(base * (2.0 - 2.0 ** (1 - level)) + 0.5)


def round_bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even) and
    return them as float32. NumPy has no bfloat16; the atlases are carried
    as float32 on the host and cast (exactly) to ``torch.bfloat16`` at
    upload."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def build_mip_atlas(images: np.ndarray) -> np.ndarray:
    """Pack (N, S, S, C) base images into (N, S, 2S, C) mip atlases.

    Box-filter downsampling; S must be a power of two.
    """
    images = np.asarray(images, np.float32)
    n, s, s2, c = images.shape
    assert s == s2 and (s & (s - 1)) == 0, "textures must be square pow2"
    atlas = np.zeros((n, s, 2 * s, c), np.float32)
    atlas[:, :, :s] = images
    level = images
    size = s
    lv = 1
    while size > 1:
        level = level.reshape(n, size // 2, 2, size // 2, 2, c).mean(
            axis=(2, 4))
        size //= 2
        off = mip_offset_x(lv, s)
        atlas[:, :size, off : off + size] = level
        lv += 1
    return atlas


def _mip_offsets_table(base: int, device) -> torch.Tensor:
    return torch.tensor(
        [mip_offset_x(l, base) for l in range(mip_count(base))],
        dtype=torch.float32, device=device,
    )


def _is_packed(atlas: torch.Tensor) -> bool:
    """Neighborhood-packed atlases carry 4x (2x2 footprint) or 13x
    (mip-pair footprint) the base channels; plain RGBA atlases have C=4."""
    return atlas.shape[-1] >= 16


def _packed_base_channels(c_all: int) -> int:
    """Base channel count of a packed atlas row.

    Mip-pair rows hold 13 groups (2x2 at level l + 3x3 at l+1), plain
    packed rows hold 4 (2x2). Base channels are 4 or 16, so the counts
    (52/208 vs 16/64) never collide."""
    if c_all % 13 == 0:
        return c_all // 13
    return c_all // 4


def _int(x, dev):
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


def _clip_int(i, hi):
    """``jnp.clip(i, 0, hi)`` for int32 tensors with a tensor bound."""
    return torch.minimum(torch.clamp_min(i, 0), hi)


def _level_size(base: int, lvl_f: torch.Tensor) -> torch.Tensor:
    """Texel count of a mip level: max(floor(base / 2^l + 0.5), 1)."""
    size_f = torch.tensor(float(base), dtype=torch.float32,
                          device=lvl_f.device) / torch.exp2(lvl_f)
    return torch.clamp_min(torch.floor(size_f + 0.5), 1.0)


def _gather_texel(atlas: torch.Tensor, layer, ix, iy):
    """atlas (N, H, WA, C); integer indices broadcast to pixel shape,
    flattened to a 1-D row gather."""
    n, h, w, c = atlas.shape
    flat = atlas.reshape(n * h * w, c)
    idx = (layer * h + iy) * w + ix
    return flat[idx.long()]


def sample_bilinear_level(atlas: torch.Tensor, layer, uv, level, base: int):
    """One bilinear tap of a plain (N, S, 2S, C) mip atlas at an integer
    mip ``level`` (per pixel), GL repeat addressing. Returns (..., C)."""
    dev = uv.device
    lvl = _int(level, dev)
    size_f = _level_size(base, lvl.to(torch.float32))
    offs = _mip_offsets_table(base, dev)[
        torch.clamp(lvl, 0, mip_count(base) - 1).long()]

    u = uv[..., 0] * size_f - 0.5
    v = uv[..., 1] * size_f - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    size_i = size_f.to(torch.int32)

    def wrap(i):
        return torch.remainder(i.to(torch.int32), size_i)

    x0 = wrap(u0)
    x1 = wrap(u0 + 1)
    y0 = wrap(v0)
    y1 = wrap(v0 + 1)
    ox = offs.to(torch.int32)
    layer = _int(layer, dev)
    t00 = _gather_texel(atlas, layer, x0 + ox, y0).to(torch.float32)
    t10 = _gather_texel(atlas, layer, x1 + ox, y0).to(torch.float32)
    t01 = _gather_texel(atlas, layer, x0 + ox, y1).to(torch.float32)
    t11 = _gather_texel(atlas, layer, x1 + ox, y1).to(torch.float32)
    return (t00 * (1 - fu) * (1 - fv) + t10 * fu * (1 - fv)
            + t01 * (1 - fu) * fv + t11 * fu * fv)


def _lod_split(lod, base: int, dev):
    """(l0, frac (..., 1)) of a lod clipped to [0, mips - 1]."""
    lod = torch.clamp(torch.as_tensor(lod, dtype=torch.float32, device=dev),
                      0.0, mip_count(base) - 1.0)
    l0 = torch.floor(lod)
    return l0, (lod - l0)[..., None]


def sample_trilinear(atlas: torch.Tensor, layer, uv, lod, base: int):
    """textureLod with trilinear filtering on a plain mip atlas; lod is a
    per-pixel float."""
    l0, frac = _lod_split(lod, base, uv.device)
    a = sample_bilinear_level(atlas, layer, uv, l0.to(torch.int32), base)
    b = sample_bilinear_level(
        atlas, layer, uv,
        torch.clamp_max(l0 + 1, mip_count(base) - 1).to(torch.int32), base)
    return a * (1 - frac) + b * frac


def sample_base(atlas: torch.Tensor, layer, uv, base: int,
                quad: bool = False):
    """Bilinear tap at mip 0 (``texture()`` without explicit derivatives,
    as the GBuffer pass effectively uses for magnified textures)."""
    zero = torch.zeros((), dtype=torch.int32, device=uv.device)
    if quad or _is_packed(atlas):
        return sample_bilinear_level_packed(atlas, layer, uv, zero, base,
                                            quad=quad)
    return sample_bilinear_level(atlas, layer, uv, zero, base)


# ------------------------------------------------------------------- cubemap


def cube_direction_to_face_uv(d):
    """GL/Vulkan cube face selection. d: (..., 3) direction (need not be
    normalized). Returns (face (...,) int32, uv (..., 2))."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    eps = 1e-20
    # face indices: 0:+X 1:-X 2:+Y 3:-Y 4:+Z 5:-Z
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def sel(c, a, b):
        return torch.where(c, torch.full_like(x, a, dtype=torch.int32),
                           torch.full_like(x, b, dtype=torch.int32))

    face = torch.where(
        is_x, sel(x >= 0, 0, 1),
        torch.where(is_y, sel(y >= 0, 2, 3), sel(z >= 0, 4, 5)),
    )
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp_min(ma, eps)
    sc = torch.where(
        is_x,
        torch.where(x >= 0, -z, z),
        torch.where(is_y, x, torch.where(z >= 0, x, -x)),
    )
    tc = torch.where(
        is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    return face, torch.stack([u, v], -1)


def sample_cubemap_lod(cube_atlas: torch.Tensor, cube_index, direction, lod,
                       base: int, quad: bool = False):
    """textureLod(samplerCube, dir, lod).

    cube_atlas: (6 * n_cubemaps, S, 2S, C) - faces are consecutive layers
    (+X, -X, +Y, -Y, +Z, -Z). Face-edge filtering is clamped per face
    (seam-approximate): uv is clamped half a texel of the lod's level
    inside the face."""
    dev = direction.device
    face, uv = cube_direction_to_face_uv(direction)
    lod = torch.as_tensor(lod, dtype=torch.float32, device=dev)
    size_f = torch.clamp_min(
        torch.tensor(float(base), dtype=torch.float32, device=dev)
        / torch.exp2(torch.clamp(torch.floor(lod), 0, mip_count(base) - 1)),
        1.0)
    half = (0.5 / size_f)[..., None]
    uv = torch.minimum(torch.maximum(uv, half), 1.0 - half)
    layer = _int(cube_index, dev) * 6 + face
    if quad or _is_packed(cube_atlas):
        return sample_trilinear_packed(cube_atlas, layer, uv, lod, base,
                                       quad=quad)
    return sample_trilinear(cube_atlas, layer, uv, lod, base)


# ------------------------------------------------- neighborhood-packed atlas


def build_packed_mip_atlas(images: np.ndarray) -> np.ndarray:
    """Pack (N, S, S, C) images into (N, S, 2S, 4C) mip atlases where each
    texel row also carries its +x, +y and +x+y neighbors (edge-clamped).

    One row fetch then returns the full 2x2 bilinear footprint.
    """
    images = np.asarray(images, np.float32)
    n, s, s2, c = images.shape
    assert s == s2 and (s & (s - 1)) == 0

    def neighborhood(level):  # (n, sz, sz, c) -> (n, sz, sz, 4c)
        xp = np.minimum(np.arange(level.shape[2]) + 1, level.shape[2] - 1)
        yp = np.minimum(np.arange(level.shape[1]) + 1, level.shape[1] - 1)
        return np.concatenate(
            [
                level,
                level[:, :, xp],
                level[:, yp, :],
                level[:, yp][:, :, xp],
            ],
            axis=-1,
        )

    atlas = np.zeros((n, s, 2 * s, 4 * c), np.float32)
    level = images
    size = s
    lv = 0
    while True:
        off = mip_offset_x(lv, s)
        atlas[:, :size, off : off + size] = neighborhood(level)
        if size == 1:
            break
        level = level.reshape(n, size // 2, 2, size // 2, 2, c).mean(
            axis=(2, 4)
        )
        size //= 2
        lv += 1
    return atlas


def build_mip_pair_atlas(images: np.ndarray) -> np.ndarray:
    """Pack (N, S, S, C) images into (N, S, 2S, 13C) mip atlases where each
    texel row carries its full 2x2 bilinear footprint at its own level
    PLUS the 3x3 footprint at the next level, anchored at
    (x//2 - 1, y//2 - 1) - which covers the next level's 2x2 bilinear
    window for every sub-texel position. A trilinear sample then needs
    ONE row fetch per pixel.
    """
    images = np.asarray(images, np.float32)
    n, s, s2_, c = images.shape
    assert s == s2_ and (s & (s - 1)) == 0

    levels = [images]
    size = s
    while size > 1:
        size //= 2
        levels.append(
            levels[-1].reshape(n, size, 2, size, 2, c).mean(axis=(2, 4))
        )

    # In-place group writes + a thread pool over (level, group): the 13
    # fancy-index expansions are independent slab writes into disjoint
    # channel ranges.
    from concurrent.futures import ThreadPoolExecutor

    atlas = np.zeros((n, s, 2 * s, 13 * c), np.float32)

    def write_group(lv, g):
        level = levels[lv]
        size = level.shape[1]
        nxt = levels[min(lv + 1, len(levels) - 1)]
        sn = nxt.shape[1]
        x = np.arange(size)
        y = np.arange(size)
        off = mip_offset_x(lv, s)
        dst = atlas[:, :size, off : off + size, g * c : (g + 1) * c]
        if g == 0:
            dst[:] = level
        elif g == 1:
            xp = np.minimum(x + 1, size - 1)
            dst[:] = level[:, :, xp]
        elif g == 2:
            yp = np.minimum(y + 1, size - 1)
            dst[:] = level[:, yp, :]
        elif g == 3:
            xp = np.minimum(x + 1, size - 1)
            yp = np.minimum(y + 1, size - 1)
            dst[:] = level[:, yp][:, :, xp]
        else:
            dy, dx = divmod(g - 4, 3)
            gy = np.clip(y // 2 - 1 + dy, 0, sn - 1)
            gx = np.clip(x // 2 - 1 + dx, 0, sn - 1)
            dst[:] = nxt[:, gy][:, :, gx]

    tasks = [(lv, g) for lv in range(len(levels)) for g in range(13)]
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(lambda t: write_group(*t), tasks))
    return atlas


def build_quad_packed_atlas(images: np.ndarray) -> np.ndarray:
    """2x2-packed atlas with 4 x-adjacent texel rows fused per table row
    (shape (N, S, S/2, 16C)): 4x fewer table rows; the right base is
    picked from the fetched row with two binary selects."""
    packed = build_packed_mip_atlas(images)
    n, s, w2, c4 = packed.shape
    return packed.reshape(n, s, w2 // 4, 4 * c4)


def _np_to_dtype(a: np.ndarray, bf16: bool) -> np.ndarray:
    """Host-side cast: bfloat16 atlases stay float32 arrays holding
    bf16-rounded values (see ``round_bf16``)."""
    a = np.asarray(a, np.float32)
    return round_bf16(a) if bf16 else a


def build_mip_pair_atlas_host(images, bf16: bool = True) -> np.ndarray:
    """Mip-pair atlas build on the host (NumPy); the caller uploads once."""
    return _np_to_dtype(
        build_mip_pair_atlas(np.asarray(images, np.float32)), bf16)


def build_quad_packed_atlas_host(images, bf16: bool = True) -> np.ndarray:
    """``build_quad_packed_atlas`` + cast, on the host."""
    return _np_to_dtype(
        build_quad_packed_atlas(np.asarray(images, np.float32)), bf16)


def _quad_gather(atlas_q: torch.Tensor, layer, ix, iy, c4: int):
    """Fetch the 2x2-packed group for global atlas column ``ix`` from a
    quad-packed atlas: one row gather + 2-level binary select."""
    n, h, wq, cq = atlas_q.shape
    flat = atlas_q.reshape(n * h * wq, cq)
    idx = (layer * h + iy) * wq + torch.div(ix, 4, rounding_mode="floor")
    row = flat[idx.long()]
    j = torch.remainder(ix, 4)
    half = torch.where((j[..., None] & 2) == 0, row[..., : 2 * c4],
                       row[..., 2 * c4:])
    return torch.where((j[..., None] & 1) == 0, half[..., :c4],
                       half[..., c4:])


def sample_bilinear_level_packed(atlas4: torch.Tensor, layer, uv, level,
                                 base: int, quad: bool = False):
    """Bilinear tap from a neighborhood-packed atlas: ONE row fetch per
    pixel (repeat across tile repeats, clamp at mip borders). Works on
    2x2-packed (4C), mip-pair (13C) and - with ``quad=True`` - quad-packed
    (4 x 4C) layouts; the level-l 2x2 occupies the first 4 groups of each.

    This is the plain version that ``ops/window_tap.py``'s kernel is held
    against (same index math, same lerp order)."""
    c4 = atlas4.shape[-1] // 4 if quad else atlas4.shape[-1]
    c = _packed_base_channels(c4)
    dev = uv.device
    lvl = _int(level, dev)
    size_f = _level_size(base, lvl.to(torch.float32))
    offs = _mip_offsets_table(base, dev)[
        torch.clamp(lvl, 0, mip_count(base) - 1).long()]

    uw = uv[..., 0] - torch.floor(uv[..., 0])
    vw = uv[..., 1] - torch.floor(uv[..., 1])
    u = uw * size_f - 0.5
    v = vw * size_f - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    size_i = size_f.to(torch.int32)
    x0 = _clip_int(u0.to(torch.int32), size_i - 1)
    y0 = _clip_int(v0.to(torch.int32), size_i - 1)
    fu = torch.clamp(u - x0.to(torch.float32), 0.0, 1.0)[..., None]
    fv = torch.clamp(v - y0.to(torch.float32), 0.0, 1.0)[..., None]

    ox = offs.to(torch.int32)
    layer = _int(layer, dev).broadcast_to(x0.shape)
    if quad:
        texel = _quad_gather(atlas4, layer, x0 + ox, y0, c4)  # (..., 4c)
    else:
        texel = _gather_texel(atlas4, layer, x0 + ox, y0)  # (..., 4c)
    t00 = texel[..., 0:c].to(torch.float32)
    t10 = texel[..., c : 2 * c].to(torch.float32)
    t01 = texel[..., 2 * c : 3 * c].to(torch.float32)
    t11 = texel[..., 3 * c : 4 * c].to(torch.float32)
    top = t00 * (1 - fu) + t10 * fu
    bot = t01 * (1 - fu) + t11 * fu
    return top * (1 - fv) + bot * fv


def sample_trilinear_pair(atlas13: torch.Tensor, layer, uv, lod, base: int):
    """Trilinear from a mip-pair atlas: ONE row fetch per pixel.

    Matches sample_trilinear (repeat addressing, clamp at mip borders,
    linear mip blend); the level-(l+1) 2x2 window is selected out of the
    stored 3x3 with binary row/column selects. The fetched row stays in
    the atlas dtype (bf16); each 4-channel group is cast to f32 on its own,
    which is exact."""
    dev = uv.device
    c = atlas13.shape[-1] // 13
    l0, frac = _lod_split(lod, base, dev)
    lvl = l0.to(torch.int32)
    size_f = _level_size(base, l0)
    offs = _mip_offsets_table(base, dev)[
        torch.clamp(lvl, 0, mip_count(base) - 1).long()]

    uw = uv[..., 0] - torch.floor(uv[..., 0])
    vw = uv[..., 1] - torch.floor(uv[..., 1])
    u = uw * size_f - 0.5
    v = vw * size_f - 0.5
    size_i = size_f.to(torch.int32)
    x0 = _clip_int(torch.floor(u).to(torch.int32), size_i - 1)
    y0 = _clip_int(torch.floor(v).to(torch.int32), size_i - 1)
    fu = torch.clamp(u - x0.to(torch.float32), 0.0, 1.0)[..., None]
    fv = torch.clamp(v - y0.to(torch.float32), 0.0, 1.0)[..., None]

    layer = _int(layer, dev).broadcast_to(x0.shape)
    row = _gather_texel(atlas13, layer, x0 + offs.to(torch.int32), y0)

    def grp(i):
        return row[..., i * c : (i + 1) * c]

    def grpf(i):
        return grp(i).to(torch.float32)

    lo_top = grpf(0) * (1 - fu) + grpf(1) * fu
    lo_bot = grpf(2) * (1 - fu) + grpf(3) * fu
    lo = lo_top * (1 - fv) + lo_bot * fv

    # Level l0+1 bilinear out of the 3x3 (groups 4..12, row-major dy, dx).
    s2 = torch.clamp_min(size_f * 0.5, 1.0)
    s2_i = s2.to(torch.int32)
    u2 = uw * s2 - 0.5
    v2 = vw * s2 - 0.5
    x20 = _clip_int(torch.floor(u2).to(torch.int32), s2_i - 1)
    y20 = _clip_int(torch.floor(v2).to(torch.int32), s2_i - 1)
    fu2 = torch.clamp(u2 - x20.to(torch.float32), 0.0, 1.0)[..., None]
    fv2 = torch.clamp(v2 - y20.to(torch.float32), 0.0, 1.0)[..., None]
    half_x = torch.div(x0, 2, rounding_mode="floor")
    half_y = torch.div(y0, 2, rounding_mode="floor")
    r0 = (torch.clamp(x20 - (half_x - 1), 0, 1) == 0)[..., None]
    q0 = (torch.clamp(y20 - (half_y - 1), 0, 1) == 0)[..., None]

    def nrow(dy):
        a = torch.where(q0, grpf(4 + dy * 3), grpf(7 + dy * 3))
        b = torch.where(q0, grpf(5 + dy * 3), grpf(8 + dy * 3))
        cc = torch.where(q0, grpf(6 + dy * 3), grpf(9 + dy * 3))
        return a, b, cc

    a0, b0, c0 = nrow(0)
    a1, b1, c1 = nrow(1)
    t00h = torch.where(r0, a0, b0)
    t10h = torch.where(r0, b0, c0)
    t01h = torch.where(r0, a1, b1)
    t11h = torch.where(r0, b1, c1)
    hi_top = t00h * (1 - fu2) + t10h * fu2
    hi_bot = t01h * (1 - fu2) + t11h * fu2
    hi = hi_top * (1 - fv2) + hi_bot * fv2
    return lo * (1 - frac) + hi * frac


def sample_trilinear_packed(atlas4: torch.Tensor, layer, uv, lod, base: int,
                            quad: bool = False):
    """Trilinear from a packed atlas: one row fetch (mip-pair layout) or
    two (2x2 / quad layouts)."""
    if not quad and atlas4.shape[-1] % 13 == 0:
        return sample_trilinear_pair(atlas4, layer, uv, lod, base)
    l0, frac = _lod_split(lod, base, uv.device)
    a = sample_bilinear_level_packed(atlas4, layer, uv, l0.to(torch.int32),
                                     base, quad=quad)
    b = sample_bilinear_level_packed(
        atlas4, layer, uv,
        torch.clamp_max(l0 + 1, mip_count(base) - 1).to(torch.int32), base,
        quad=quad)
    return a * (1 - frac) + b * frac


# ------------------------------------------------- merged environment tap
# The index and filter halves of the mip-pair and quad samplers, split so
# that ``ops/envtap.py`` can fetch one row of a merged table per pixel and
# filter it as the slot that pixel chose. They serve only the merged tap.


def build_quad_pair_atlas_np(images: np.ndarray) -> np.ndarray:
    """Mip-pair atlas with 4 x-adjacent texel rows fused per table row:
    (N, S, S, C) -> (N, S, S/2, 52C). One row then serves a full trilinear
    sample for any of its 4 base texels (pair filtering after a 4-way base
    select): the cubemap's rows of the merged environment table."""
    pair = build_mip_pair_atlas(images)
    n, s, w2, c13 = pair.shape
    return pair.reshape(n, s, w2 // 4, 4 * c13)


def build_quad_pair_atlas_host(images, bf16: bool = True) -> np.ndarray:
    """``build_quad_pair_atlas_np`` + cast, on the host."""
    return _np_to_dtype(
        build_quad_pair_atlas_np(np.asarray(images, np.float32)), bf16)


def build_quad_pair_atlas_device(images: torch.Tensor,
                                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """``build_quad_pair_atlas_np`` on the device the images lie on:
    the same box means (each level the mean of its four parents, summed
    in the NumPy builder's order) and the same neighbour groups."""
    img = images.to(torch.float32)
    n, s, s2, c = img.shape
    assert s == s2 and (s & (s - 1)) == 0
    dev = img.device
    levels = [img]
    size = s
    while size > 1:
        size //= 2
        lv = levels[-1].reshape(n, size, 2, size, 2, c)
        # np.mean over axes (2, 4): the four parents summed in order,
        # divided by 4.
        levels.append((((lv[:, :, 0, :, 0] + lv[:, :, 0, :, 1])
                        + lv[:, :, 1, :, 0]) + lv[:, :, 1, :, 1]) / 4.0)
    atlas = torch.zeros((n, s, 2 * s, 13 * c), dtype=torch.float32,
                        device=dev)
    for lv, level in enumerate(levels):
        size = level.shape[1]
        nxt = levels[min(lv + 1, len(levels) - 1)]
        sn = nxt.shape[1]
        i = torch.arange(size, device=dev)
        ip = torch.clamp_max(i + 1, size - 1)
        groups = [level, level[:, :, ip], level[:, ip, :],
                  level[:, ip][:, :, ip]]
        for dy in range(3):
            gy = torch.clamp(torch.div(i, 2, rounding_mode="floor") - 1 + dy,
                             0, sn - 1)
            for dx in range(3):
                gx = torch.clamp(
                    torch.div(i, 2, rounding_mode="floor") - 1 + dx, 0,
                    sn - 1)
                groups.append(nxt[:, gy][:, :, gx])
        off = mip_offset_x(lv, s)
        atlas[:, :size, off : off + size] = torch.cat(groups, dim=-1)
    return atlas.reshape(n, s, s // 2, 52 * c).to(out_dtype)


def pair_row_context(layer, uv, lod, base: int):
    """Index half of ``sample_trilinear_pair``: returns (layer, x_global,
    y, ctx), the texel of the unquadded (N, S, 2S) pair atlas; the caller
    maps it to a table row (of a quad-fused table: x // 4, then a select by
    ``ctx["qj"]`` = x % 4)."""
    dev = uv.device
    l0, frac = _lod_split(lod, base, dev)
    lvl = l0.to(torch.int32)
    size_f = _level_size(base, l0)
    offs = _mip_offsets_table(base, dev)[
        torch.clamp(lvl, 0, mip_count(base) - 1).long()]

    uw = uv[..., 0] - torch.floor(uv[..., 0])
    vw = uv[..., 1] - torch.floor(uv[..., 1])
    u = uw * size_f - 0.5
    v = vw * size_f - 0.5
    size_i = size_f.to(torch.int32)
    x0 = _clip_int(torch.floor(u).to(torch.int32), size_i - 1)
    y0 = _clip_int(torch.floor(v).to(torch.int32), size_i - 1)
    fu = torch.clamp(u - x0.to(torch.float32), 0.0, 1.0)[..., None]
    fv = torch.clamp(v - y0.to(torch.float32), 0.0, 1.0)[..., None]

    s2 = torch.clamp_min(size_f * 0.5, 1.0)
    s2_i = s2.to(torch.int32)
    u2 = uw * s2 - 0.5
    v2 = vw * s2 - 0.5
    x20 = _clip_int(torch.floor(u2).to(torch.int32), s2_i - 1)
    y20 = _clip_int(torch.floor(v2).to(torch.int32), s2_i - 1)
    fu2 = torch.clamp(u2 - x20.to(torch.float32), 0.0, 1.0)[..., None]
    fv2 = torch.clamp(v2 - y20.to(torch.float32), 0.0, 1.0)[..., None]
    xg = x0 + offs.to(torch.int32)
    half_x = torch.div(x0, 2, rounding_mode="floor")
    half_y = torch.div(y0, 2, rounding_mode="floor")
    ctx = {
        "frac": frac, "fu": fu, "fv": fv, "fu2": fu2, "fv2": fv2,
        "r": torch.clamp(x20 - (half_x - 1), 0, 1)[..., None],
        "q": torch.clamp(y20 - (half_y - 1), 0, 1)[..., None],
        "qj": torch.remainder(xg, 4),
    }
    layer = _int(layer, dev).broadcast_to(x0.shape)
    return layer, xg, y0, ctx


def pair_filter_row(row, ctx, c: int):
    """Filter half of ``sample_trilinear_pair``: ``row`` is the fetched
    (..., 13c) mip-pair texel row, kept in the atlas dtype (selects do not
    round; each group is cast to float32 on its own, which is exact)."""
    fu, fv, fu2, fv2, frac = (ctx["fu"], ctx["fv"], ctx["fu2"],
                              ctx["fv2"], ctx["frac"])

    def grp(i):
        return row[..., i * c : (i + 1) * c]

    def grpf(i):
        return grp(i).to(torch.float32)

    lo_top = grpf(0) * (1 - fu) + grpf(1) * fu
    lo_bot = grpf(2) * (1 - fu) + grpf(3) * fu
    lo = lo_top * (1 - fv) + lo_bot * fv

    r0 = ctx["r"] == 0
    q0 = ctx["q"] == 0

    def nrow(dy):
        a = torch.where(q0, grp(4 + dy * 3), grp(7 + dy * 3))
        b = torch.where(q0, grp(5 + dy * 3), grp(8 + dy * 3))
        cc = torch.where(q0, grp(6 + dy * 3), grp(9 + dy * 3))
        return a, b, cc

    a0, b0, c0 = nrow(0)
    a1, b1, c1 = nrow(1)
    t00h = torch.where(r0, a0, b0).to(torch.float32)
    t10h = torch.where(r0, b0, c0).to(torch.float32)
    t01h = torch.where(r0, a1, b1).to(torch.float32)
    t11h = torch.where(r0, b1, c1).to(torch.float32)
    hi_top = t00h * (1 - fu2) + t10h * fu2
    hi_bot = t01h * (1 - fu2) + t11h * fu2
    hi = hi_top * (1 - fv2) + hi_bot * fv2
    return lo * (1 - frac) + hi * frac


def quad_select(row, j, c4: int):
    """Pick base j (= x % 4) out of a quad-fused row (..., 4 * c4)."""
    half = torch.where((j[..., None] & 2) == 0, row[..., : 2 * c4],
                       row[..., 2 * c4 : 4 * c4])
    return torch.where((j[..., None] & 1) == 0, half[..., :c4],
                       half[..., c4:])


def quad_row_context(layer, uv, base: int):
    """Index half of the quad-packed mip-0 bilinear tap (``sample_base``
    with ``quad=True``): returns (layer, x, y, ctx)."""
    dev = uv.device
    size_f = float(base)
    uw = uv[..., 0] - torch.floor(uv[..., 0])
    vw = uv[..., 1] - torch.floor(uv[..., 1])
    u = uw * size_f - 0.5
    v = vw * size_f - 0.5
    x0 = torch.clamp(torch.floor(u).to(torch.int32), 0, base - 1)
    y0 = torch.clamp(torch.floor(v).to(torch.int32), 0, base - 1)
    fu = torch.clamp(u - x0.to(torch.float32), 0.0, 1.0)[..., None]
    fv = torch.clamp(v - y0.to(torch.float32), 0.0, 1.0)[..., None]
    layer = _int(layer, dev).broadcast_to(x0.shape)
    return layer, x0, y0, {"fu": fu, "fv": fv, "qj": torch.remainder(x0, 4)}


def quad_filter_row(row, ctx, c: int):
    """Filter half of the quad bilinear tap: ``row`` is the selected
    (..., 4c) 2x2-packed group, kept in the atlas dtype."""
    fu, fv = ctx["fu"], ctx["fv"]
    t00 = row[..., 0:c].to(torch.float32)
    t10 = row[..., c : 2 * c].to(torch.float32)
    t01 = row[..., 2 * c : 3 * c].to(torch.float32)
    t11 = row[..., 3 * c : 4 * c].to(torch.float32)
    top = t00 * (1 - fu) + t10 * fu
    bot = t01 * (1 - fu) + t11 * fu
    return top * (1 - fv) + bot * fv
