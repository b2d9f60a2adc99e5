"""The frame graph: one function replaces RecordCommandBuffer
(ZeldaEngine.cpp:3160-3744) + DrawFrame submission (:1940-2033).

Pass order (matching the reference's hard-coded command order):
  1. Shadowmap (all objects, depth-only, two-sided)         :3239-3393
  2. DeferredScene -> 6-target GBuffer                      :3417-3480
  3. (depth copy GBuffer->main = reusing the depth tensor)  :3482-3506
  4. Main pass: DeferredLighting fullscreen                 :3536-3539
     forward objects (z-tested against scene depth)         :3545-3579
     skydome (LESS_OR_EQUAL)                                :3682-3691
     (skydome skipped when debug view != 0)

This is the slice of the JAX package's ``passes/frame.py`` that a
full-frame, single-device frame runs: vertex stage -> meshlet frustum +
cone cull (``ops/culling.py``; the camera's, and the light's for the
shadow casters) -> live-triangle compaction (``compact_setup``, where the
config sets a cap) -> shadow raster
(kernel ``pair_raster``) -> fused GBuffer raster (``pair_raster_fused``)
-> materials (per-combo constants + one mip-pair atlas fetch of the
varying channels) -> 25-tap PCF (``pcf_taps``; or an opt-in backend:
``pcf_window``, the window tables of ``pcf_window_table`` /
``pcf_window2d_table``, or a plain filter) -> directional light + point
lights culled to screen tiles (``point_lights``; or the plain loop /
tiled loop) -> cube reflection (constant-lod table, half-resolution
mip-pair cube or quad atlas) -> forward objects, z-tested against the
GBuffer depth (``pair_raster_fused`` with an initial depth, their own
light cull and PCF) -> analytic skydome (``bilinear_tap``) or the
rasterized dome mesh (``pair_raster`` with ids and the frame's depth as
its initial depth), then the background rect at z = 1 (``bilinear_tap``),
or one of the debug views 1-9 instead of the lit frame. Opt-in: the
wireframe edge mask (``config.wireframe``), the validation counters
(``config.validation``, ``aux["validation"]``), the merged environment
tap (``config.env_merge``: reflection, sky and background rows in one
fetch, ``ops/envtap.py``), the half-resolution reflection tap
(``config.reflection_half``), aligned pair bins (``config.pair_align``),
the rasterizers' occlusion early-out (``config.raster_early_out``) and the
diagnostic ablations (``config.ablate``, each a substring test as in the
JAX package). ``render_rows`` also renders a row band of the frame
(``y0``, ``rows``, ``full_frame=False``; the shadow map as a band of its
own rows, gathered by the caller), the multi-device path of
``parallel/tiles.py``: K1/K2 rasterize the tile rows that hold the band
(``y0_tiles``) and the band is cropped out of them. ``config.raster``
takes the port's names ("auto", "cuda", "torch") and the JAX package's
raster values: "fused" is the default route above, "pallas" rasterizes
the GBuffer and forward passes through ``pair_raster`` with ids and
resolves their attributes through the gather path
(``passes/gbuffer.py::surface_attributes``), "jnp" rasterizes every pass
brute force (``ops/rasterize.py``) before the same gather path
(``raster_route``); the other kernels follow the tensors' device under
them (``kernel_backend``). Nothing is silently served by another path:
an unknown backend name raises.

Every op is issued on the current CUDA stream in order: the stream is the
dependency graph.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.math.color import gamma_correct
from zeldaengine_tpu_torch.math.transforms import (
    apply_mat4_h, apply_mat4_point, mat4_product)
from zeldaengine_tpu_torch.ops import pbr
from zeldaengine_tpu_torch.ops.culling import (
    expand_meshlet_mask, meshlet_cull)
from zeldaengine_tpu_torch.ops.lighting import (
    cull_point_lights_tiled, shade_pixels)
from zeldaengine_tpu_torch.ops.pcf_cuda import compute_pcf_vmem
from zeldaengine_tpu_torch.ops.pcf_window import compute_pcf_pallas
from zeldaengine_tpu_torch.ops.envtap import sample_env_merged
from zeldaengine_tpu_torch.ops.rasterize import (
    _pixel_grid,
    interpolation_coeffs,
    rasterize_depth,
    rasterize_visibility,
    triangle_setup,
)
from zeldaengine_tpu_torch.ops.rasterize_cuda import (
    build_pairs,
    compact_setup,
    count_oversized,
    fused_extra_width,
    rasterize_pairs,
    rasterize_pairs_fused,
    remap_pair_tri,
)
from zeldaengine_tpu_torch.ops.shadow import (
    compute_pcf,
    compute_pcf_half,
    compute_pcf_packed,
    compute_pcf_packed4,
    compute_pcf_packed_roll,
    compute_pcf_packed_y,
    compute_pcf_window1,
    compute_pcf_window_roll,
    compute_shadow_coord,
)
from zeldaengine_tpu_torch.ops.texture import sample_base, sample_cubemap_lod
from zeldaengine_tpu_torch.ops.window_tap import sample_base_window
from zeldaengine_tpu_torch.passes.gbuffer import (
    GBuffer,
    SurfaceAttributes,
    pack_gbuffer,
    surface_attributes,
    surface_attributes_from_planes,
)
from zeldaengine_tpu_torch.scene.scenebuild import GpuScene, SceneMeta

# The port's own names ("auto", "cuda", "torch") and the JAX package's
# raster values ("pallas", "fused", "jnp"; "auto" is both).
_RASTER_BACKENDS = ("auto", "cuda", "torch", "pallas", "fused", "jnp")
_PCF_BACKENDS = ("auto", "vmem", "exact", "packed", "packed_b",
                 "packed_roll", "window_roll", "half", "half_nearest",
                 "half_wr", "half_y4", "pallas", "packed_y4", "packed_y8",
                 "packed4", "packed8", "packed16", "window1")


def kernel_backend(config: EngineConfig) -> str:
    """The ``backend`` the frame passes to every kernel wrapper: the port's
    "cuda" (the kernel, or raise) and "torch" (the plain version) pass
    through; the JAX package's raster values pick the raster route only,
    and under them, as under "auto", each wrapper follows its tensors'
    device (the kernel on the card, the plain version on the CPU)."""
    return config.raster if config.raster in ("cuda", "torch") else "auto"


def raster_route(config: EngineConfig) -> str:
    """How the GBuffer and forward passes find their visible surface:
    "planes" (kernel ``pair_raster_fused``'s attribute planes, resolved by
    ``surface_attributes_from_planes``: "auto", "cuda", "torch" and the
    JAX package's "fused", at every ``tile_w``), "ids" (kernel
    ``pair_raster`` with ids, then the gather path ``surface_attributes``:
    "pallas") or "brute" (the brute-force ``rasterize_visibility``, no
    compaction or pair stream, then the gather path: "jnp"; the shadow map
    through ``rasterize_depth`` and the dome mesh brute force too)."""
    return {"pallas": "ids", "jnp": "brute"}.get(config.raster, "planes")


def point_light_route(view, config: EngineConfig):
    """How a frame shades its point lights: "kernel" (culled to
    (point_block_h, 128) blocks, shaded by kernel ``point_lights``),
    "tiled" (culled to light tiles, the plain tiled loop) or None (the
    plain loop over every slot). The JAX package's "auto" takes the kernel
    on an accelerator only; the port's device is the card, so "auto"
    takes it on every device (the plain version serves CPU tensors).
    "unroll" is the plain loop, or the tiled loop once the table reaches
    tiled_lights_min slots."""
    n_slots = view.point_lights.shape[0]
    if (config.point_light_kernel in ("pallas", "auto")
            and n_slots >= config.point_kernel_min
            and config.width % 128 == 0):
        return "kernel"
    if (n_slots >= config.tiled_lights_min
            and config.width % config.light_tile_w == 0):
        return "tiled"
    return None


def cull_lights(view, config: EngineConfig, route, attrs, y0: int = 0):
    """The point lights of one pass culled against its visible surface
    (``attrs.world_pos`` / ``covered``, whose rows are those of the row
    band from viewport row ``y0``) for ``route``: (tiled_points,
    pallas_points, light drops), Nones where the route takes no cull."""
    if route is None:
        return None, None, None
    if route == "kernel":
        tile_h, tile_w = config.point_block_h, 128
    else:
        tile_h, tile_w = config.light_tile_h, config.light_tile_w
    tile_idx, tile_cnt, drops = cull_point_lights_tiled(
        view.point_lights, int(view.lights_count[1]), view, config.width,
        attrs.world_pos.shape[0], tile_h, tile_w, config.max_tile_lights,
        y0=y0, vp_h=config.height, world_pos=attrs.world_pos,
        covered=attrs.covered)
    if route == "kernel":
        return None, (tile_idx, tile_cnt, tile_h,
                      kernel_backend(config)), drops
    return (tile_idx, tile_cnt, tile_h, tile_w), None, drops


def _pad_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _band_tiles(y0: int, height: int, tile_h: int):
    """The whole tile rows that hold pixel rows [y0, y0 + height): (first
    tile row, the rows they span, row y0's offset in them). The pair
    rasterizers render that span (``y0_tiles``) and the caller crops the
    band out of it, so a band at any row, of any height, goes through
    the kernels; the JAX package's frame sends such a band to its jnp
    raster instead (``passes/frame.py::_use_pallas``). The full frame is
    the span from row 0, padded to whole tiles."""
    off = y0 % tile_h
    return y0 // tile_h, _pad_up(off + height, tile_h), off


def _band_mask_setup(setup, y0: int, rows_px: int):
    """Restrict a TriangleSetup to triangles whose bbox intersects pixel
    rows [y0, y0 + rows_px): with ``config.compact_tris`` set, a band's
    compaction and binning then track the band's triangle count.
    ``build_pairs`` applies the same band test to its keys, so this only
    tightens ``valid`` earlier."""
    b = setup.bbox
    band = (b[:, 3] > float(y0)) & (b[:, 1] < float(y0) + rows_px)
    return setup._replace(valid=setup.valid & band)


def _maybe_compact(setup, extra, cap: Optional[int],
                   config: EngineConfig):
    """Live-triangle compaction when ``cap`` (``config.compact_tris``, or
    ``compact_tris_shadow`` for the shadow pass) is set and smaller than
    the pool: the pair binning then tracks the live count instead of the
    pool's capacity. Returns (setup, extra, original ids of the compacted
    rows or None, live triangles the cap dropped)."""
    if cap is None or cap >= setup.edge.shape[0]:
        return setup, extra, None, 0
    return compact_setup(setup, cap, extra=extra,
                         center_cull=config.subpixel_cull)


def _fused_extra(scene, n_t: int, world, n_world, tri_idx=None,
                 need_uv: bool = True, need_combo: bool = True):
    """Per-triangle fused-record payload (T, fused_extra_width(flags)):
    material-combo id (as a float value, elided when every triangle
    shares one combo) + 3 corners x (uv2 [elided for textureless
    flat-normal scenes], color3, world-pos3, world-normal3). O(T) work
    once per frame instead of a per-PIXEL record gather.

    ``tri_idx``: compacted original-triangle ids (``compact_setup``): the
    corner gather then runs over the cap rows instead of the first
    ``n_t`` triangles of the pool. Rows whose id is the dead sentinel
    gather the last triangle harmlessly (their records are forced to the
    never-record by ``setup.valid``)."""
    static = (scene.pair_static[:, :5] if need_uv
              else scene.pair_static[:, 2:5])
    pair_all = torch.cat([static, world, n_world], dim=1)  # (P, 11 or 9)
    cw = pair_all.shape[1]
    if tri_idx is None:
        rows = slice(0, n_t)
    else:
        rows = torch.clamp_max(tri_idx, scene.tri_vtx.shape[0] - 1).long()
    tv = scene.tri_vtx[rows].long()
    corners = pair_all[tv].reshape(tv.shape[0], 3 * cw)
    if not need_combo:
        return corners
    mat = scene.tri_meta[rows, 3].long()
    combo = scene.mat_combined[mat].to(torch.float32)
    return torch.cat([combo[:, None], corners], dim=1)


def _fused_flags(meta):
    """Static record-elision flags from scene facts (SceneMeta). The uv
    columns are elidable only when NOTHING consumes them - and the TBN
    always does: the reference normalizes the map value BEFORE the 2x-1
    remap (Common.glsl:126), so even the flat default normal tilts the
    shading normal along the uv tangent frame (meta.flat_normal stays
    False). The combo column elides whenever every live triangle shares
    one combo."""
    need_uv = not (meta.tex_channels == () and meta.flat_normal)
    need_combo = meta.const_combo is None
    combo_const = 0.0 if need_combo else float(meta.const_combo)
    return need_uv, need_combo, combo_const


def _span_padded_rows(setup, height: int, padded: int):
    """The setup clamps each bbox to the viewport's ``height`` rows, but
    the tile grid pads rows below them, which the raster still covers.
    A bbox that reaches the bottom edge from inside the viewport is
    extended to the padded bottom, so that the packed strip span built
    from it holds every row its triangle covers and the kernel's span
    skip stays exact on the padded rows too. Binning is unchanged: such a
    bbox already ends in the last tile row."""
    b = setup.bbox
    reach = (b[:, 3] >= height) & (b[:, 1] < height)
    y1 = torch.where(reach, torch.full_like(b[:, 3], float(padded)), b[:, 3])
    return setup._replace(bbox=torch.stack([b[:, 0], b[:, 1], b[:, 2], y1],
                                           -1))


def _early_out_kw(config: EngineConfig, z_row: int) -> dict:
    """The rasterizers' occlusion early-out arguments: ``z_row`` is the
    record column of the z sort bucket (-1 without ``raster_zsort``); the
    kernels apply the early-out only without a strip-span column, as the
    JAX package does."""
    return dict(early_out=config.raster_early_out, z_row=z_row,
                eo_stride=config.early_out_stride)


def _raster_vis(setup, height, width, config: EngineConfig, init_depth=None,
                y0: int = 0):
    """Visibility raster with triangle ids (kernel ``pair_raster``, depth
    and ids) + tile padding: returns (depth, tid, the pair stream, live
    triangles the compaction cap dropped). As ``_raster_vis_fused``
    without the attribute payload; ``init_depth`` (H, W) is padded with
    the far plane. A band starts at viewport row ``y0`` (``_band_tiles``)."""
    y0_tiles, ph, off = _band_tiles(y0, height, config.tile_h)
    pw = _pad_up(width, max(config.tile_w, 128))
    orig_t = setup.edge.shape[0]
    setup, _, cidx, covf = _maybe_compact(setup, None, config.compact_tris,
                                          config)
    has_z = 1 if config.raster_zsort else 0
    ysr = config.sub_rows if config.raster_ysort else None
    if ysr and y0 - off + ph > config.height:
        setup = _span_padded_rows(setup, config.height, y0 - off + ph)
    pairs = build_pairs(setup, pw, ph, config.tile_h, config.tile_w,
                        expand=config.pair_expand, y0_tiles=y0_tiles,
                        max_pairs=config.max_pairs,
                        sort_z=config.raster_zsort,
                        align=config.pair_align,
                        ysort_sub_rows=ysr,
                        gather_chunks=config.pair_gather_chunks,
                        gather_pack=config.pair_gather_pack,
                        center_cull=config.subpixel_cull)
    if cidx is not None:
        pairs = remap_pair_tri(pairs, cidx, orig_t)
    if init_depth is not None and (ph != height or pw != width):
        init_depth = F.pad(init_depth,
                           (0, pw - width, off, ph - off - height),
                           value=1.0)
    depth, tid = rasterize_pairs(
        pairs, ph, pw, init_depth=init_depth, tile_h=config.tile_h,
        tile_w=config.tile_w, sub_rows=config.sub_rows,
        y_row=(12 + has_z) if ysr else -1, y0_tiles=y0_tiles,
        backend=kernel_backend(config),
        **_early_out_kw(config, 12 if has_z else -1))
    rows = slice(off, off + height)
    return depth[rows, :width], tid[rows, :width], pairs, covf


def _raster_visibility(setup, height, width, config: EngineConfig,
                       init_depth=None, y0: int = 0):
    """Depth and triangle ids of a pass without attribute planes, through
    the raster route: ``_raster_vis`` (kernel ``pair_raster`` with ids)
    or, under "brute", ``rasterize_visibility`` over every triangle (no
    compaction, no pair stream: None and 0 for them, as the JAX package's
    jnp raster adds no overflow). Returns (depth, tid, the pair stream,
    live triangles the compaction cap dropped)."""
    if raster_route(config) == "brute":
        depth, tid = rasterize_visibility(
            setup, height, width, chunk=config.tri_chunk,
            init_depth=init_depth, y0=y0)
        return depth, tid, None, 0
    return _raster_vis(setup, height, width, config, init_depth=init_depth,
                       y0=y0)


def _raster_vis_fused(setup, extra, height, width, config: EngineConfig,
                      meta=None, init_depth=None, y0: int = 0):
    """Fused visibility raster + attribute interpolation: returns
    (depth, tid, attr planes (ATTR_CH, H, W), the pair stream, live
    triangles the compaction cap dropped). The frame is padded to whole
    tiles (1080 rows -> 1088 at 64-row tiles) and cropped back;
    ``init_depth`` (H, W) is padded with the far plane. ``extra`` is the
    payload, or a callable that builds it from the compacted original ids
    (None without compaction), so that it covers the cap rows only. The
    pair stream's ``pair_tri`` holds original triangle ids. A band starts
    at viewport row ``y0`` (``_band_tiles``)."""
    need_uv, need_combo, combo_const = (
        _fused_flags(meta) if meta is not None else (True, True, 0.0))
    n_extra = fused_extra_width(need_uv, need_combo)
    y0_tiles, ph, off = _band_tiles(y0, height, config.tile_h)
    pw = _pad_up(width, max(config.tile_w, 128))
    orig_t = setup.edge.shape[0]
    # Liveness is tested on the unpadded bbox, before the span extension.
    if callable(extra):
        setup, _, cidx, covf = _maybe_compact(setup, None,
                                              config.compact_tris, config)
        extra = extra(cidx)
    else:
        setup, extra, cidx, covf = _maybe_compact(
            setup, extra, config.compact_tris, config)
    assert extra.shape[1] == n_extra, (extra.shape, n_extra)
    has_z = 1 if config.raster_zsort else 0
    ysr = config.sub_rows if config.raster_ysort else None
    if ysr and y0 - off + ph > config.height:
        setup = _span_padded_rows(setup, config.height, y0 - off + ph)
    pairs = build_pairs(setup, pw, ph, config.tile_h, config.tile_w,
                        expand=config.pair_expand, y0_tiles=y0_tiles,
                        extra=extra, max_pairs=config.max_pairs,
                        sort_z=config.raster_zsort,
                        align=config.pair_align,
                        ysort_sub_rows=ysr,
                        gather_chunks=config.pair_gather_chunks,
                        gather_pack=config.pair_gather_pack,
                        center_cull=config.subpixel_cull)
    if cidx is not None:
        pairs = remap_pair_tri(pairs, cidx, orig_t)
    kw = dict(tile_h=config.tile_h, tile_w=config.tile_w,
              sub_rows=config.sub_rows, texture_size=config.texture_size,
              y_row=(12 + n_extra + has_z) if ysr else -1, y0_tiles=y0_tiles,
              need_uv=need_uv, has_combo=need_combo,
              combo_const=combo_const,
              **_early_out_kw(config, (12 + n_extra) if has_z else -1))
    if init_depth is not None and (ph != height or pw != width):
        init_depth = F.pad(init_depth,
                           (0, pw - width, off, ph - off - height),
                           value=1.0)
    depth, tid, planes = rasterize_pairs_fused(
        pairs, ph, pw, init_depth=init_depth, backend=kernel_backend(config),
        **kw)
    rows = slice(off, off + height)
    return (depth[rows, :width], tid[rows, :width],
            planes[:, rows, :width], pairs, covf)


def _visible_surface(scene, meta, config: EngineConfig, setup, world,
                     n_world, height, width, y0: int, init_depth=None):
    """The GBuffer or forward pass's visible surface through the raster
    route (``raster_route``): (depth, tid, SurfaceAttributes, the pair
    stream or None, live triangles the compaction cap dropped). "planes":
    kernel ``pair_raster_fused`` and its attribute planes; "ids" / "brute":
    the visibility buffer of ``_raster_visibility``, then the gather path
    ``surface_attributes``. ``init_depth``: the forward pass's GBuffer
    depth."""
    if raster_route(config) != "planes":
        depth, tid, pairs, covf = _raster_visibility(
            setup, height, width, config, init_depth=init_depth, y0=y0)
        attrs = surface_attributes(
            scene, setup, tid, world, n_world, config, y0=y0,
            var_ch=meta.tex_channels, flat_normal=meta.flat_normal)
        return depth, tid, attrs, pairs, covf
    f_uv, f_combo, _ = _fused_flags(meta)
    n_t = setup.edge.shape[0]
    depth, tid, planes, pairs, covf = _raster_vis_fused(
        setup,
        lambda cidx: _fused_extra(scene, n_t, world, n_world, tri_idx=cidx,
                                  need_uv=f_uv, need_combo=f_combo),
        height, width, config, meta=meta, init_depth=init_depth, y0=y0)
    attrs = surface_attributes_from_planes(
        scene, planes, config, var_ch=meta.tex_channels,
        flat_normal=meta.flat_normal)
    return depth, tid, attrs, pairs, covf


def _apply_wireframe(attrs: SurfaceAttributes, depth, tid,
                     config: EngineConfig, fallback_depth=None):
    """ENABLE_WIREFRAME (polygonMode LINE): keep only edge pixels
    covered; interiors fall through to whatever is behind (the previous
    pass's depth, else sky/bg), matching hardware LINE rasterization of
    the same triangles."""
    edge = attrs.covered & (attrs.bary_min < config.wireframe_threshold)
    attrs = attrs._replace(covered=edge)
    fb = (torch.ones_like(depth) if fallback_depth is None
          else fallback_depth)
    depth = torch.where(edge, depth, fb)
    tid = torch.where(edge, tid, torch.full_like(tid, -1))
    return attrs, depth, tid


def _raster_depth(setup, dim, config: EngineConfig, y0: int = 0,
                  rows: Optional[int] = None):
    """The shadow map: depth-only pair raster at shadowmap resolution,
    padded to whole shadow tiles (the span of a triangle reaching the map's
    bottom edge is extended over the padded rows, as in
    ``_raster_vis_fused``) and cropped back. Returns (map, the pair stream,
    live casters the compaction cap dropped). The casters are compacted to
    their own cap (``config.compact_tris_shadow``): they are not the
    camera-culled set. The pass keeps no ids, so ``pair_tri`` stays in
    compacted rows, as in the JAX package. ``y0`` / ``rows``: the band of
    map rows [y0, y0 + rows) (``_band_tiles``). Under the "brute" route
    (``raster_route``) the map is ``rasterize_depth``'s, with no pair
    stream (None) and no compaction (0), as the JAX package's jnp raster."""
    if raster_route(config) == "brute":
        return rasterize_depth(setup, dim if rows is None else rows, dim,
                               chunk=config.tri_chunk, y0=y0), None, 0
    s_th = config.shadow_tile_h or config.tile_h
    s_tw = config.shadow_tile_w or config.tile_w
    height = dim if rows is None else rows
    y0_tiles, ph, off = _band_tiles(y0, height, s_th)
    pw = _pad_up(dim, s_tw)
    setup, _, _, covf = _maybe_compact(setup, None,
                                       config.compact_tris_shadow, config)
    has_z = 1 if config.raster_zsort else 0
    ysr = config.sub_rows if config.raster_ysort else None
    if ysr and y0 - off + ph > dim:
        setup = _span_padded_rows(setup, dim, y0 - off + ph)
    pairs = build_pairs(setup, pw, ph, s_th, s_tw,
                        expand=config.pair_expand_shadow, y0_tiles=y0_tiles,
                        max_pairs=config.max_pairs_shadow,
                        sort_z=config.raster_zsort,
                        align=config.pair_align,
                        ysort_sub_rows=ysr,
                        gather_chunks=config.pair_gather_chunks,
                        gather_pack=config.pair_gather_pack,
                        center_cull=config.subpixel_cull)
    kw = dict(tile_h=s_th, tile_w=s_tw, sub_rows=config.sub_rows,
              depth_only=True, y_row=(12 + has_z) if ysr else -1,
              y0_tiles=y0_tiles, **_early_out_kw(config, 12 if has_z else -1))
    depth = rasterize_pairs(pairs, ph, pw, backend=kernel_backend(config),
                            **kw)
    return depth[off:off + height, :dim], pairs, covf


def _shadow_factor(shadowmap, world_pos, view, config: EngineConfig,
                   valid=None):
    """The deferred shadow factor through ``config.pcf_backend``: "auto" /
    "vmem" the tap kernel; "packed" / "packed_b", "packed_roll",
    "window_roll" exact row- or window-table filters (the last two over
    the tables of the window-table kernels, on maps whose width is a
    multiple of 128); "packed_y4" / "packed_y8" (maps whose size is a
    multiple of 8), "packed4/8/16" and "window1" the exact plain table
    filters the JAX package has no kernel for; "half*" half resolution +
    upsample; "pallas" the windowed kernel (approximate by design);
    "exact" and every fallback the plain 25-gather filter. The shape
    conditions and the order are the JAX package's. Ablations
    (diagnostics): "nopcf" a factor of ones, "pcfcoords" the coordinates
    without the filter, "pcfbuild" the "packed" filter without its table
    build."""
    if "nopcf" in config.ablate:
        return torch.ones(world_pos.shape[:-1], dtype=torch.float32,
                          device=world_pos.device)
    sc = compute_shadow_coord(view.shadow_space, world_pos)
    if "pcfcoords" in config.ablate:
        return 1.0 + sc[..., 0] * 1e-9 + sc[..., 2] * 1e-9
    kw = dict(radius=config.pcf_radius, scale=config.pcf_scale,
              bias=config.shadow_bias)
    backend = config.pcf_backend
    dim_ok = config.shadowmap_dim % 128 == 0
    if backend in ("packed_y4", "packed_y8") \
            and config.shadowmap_dim % 8 == 0:
        return compute_pcf_packed_y(shadowmap, sc, **kw,
                                    ygroup=int(backend[len("packed_y"):]))
    if backend in ("packed4", "packed8", "packed16"):
        return compute_pcf_packed4(shadowmap, sc, **kw,
                                   group=int(backend[len("packed"):]))
    if backend in ("half", "half_nearest", "half_wr", "half_y4") \
            and sc.ndim == 3:
        return compute_pcf_half(
            shadowmap, sc, **kw,
            upsample="nearest" if backend == "half_nearest" else "linear",
            inner={"half_wr": "window_roll",
                   "half_y4": "packed_y"}.get(backend, "packed"),
            backend=kernel_backend(config))
    if backend == "window1":
        return compute_pcf_window1(shadowmap, sc, **kw)
    if backend == "window_roll" and dim_ok:
        return compute_pcf_window_roll(shadowmap, sc, **kw,
                                       backend=kernel_backend(config))
    if backend == "packed_roll" and dim_ok:
        return compute_pcf_packed_roll(shadowmap, sc, **kw,
                                       backend=kernel_backend(config))
    if backend in ("auto", "vmem") and sc.ndim == 3:
        # The tap kernel: equal to compute_pcf at every in-range pixel.
        # Uncovered pixels (whose world_pos is the GBuffer default,
        # overwritten by sky downstream) read 1.0.
        sc = sc.contiguous()
        sf, _overflow = compute_pcf_vmem(shadowmap, sc, active=valid,
                                         backend=kernel_backend(config),
                                         **kw)
        if valid is not None:
            sf = torch.where(valid, sf, torch.ones_like(sf))
        return sf
    if backend in ("packed", "packed_b"):
        return compute_pcf_packed(
            shadowmap, sc, **kw, batch_rows=backend == "packed_b",
            _ablate_const_table=(backend == "packed"
                                 and "pcfbuild" in config.ablate))
    if backend == "pallas" and sc.ndim == 3:
        # One kernel launch from the coordinate to the factor; the last
        # tiles read zero coordinates past the frame, as padding would.
        return compute_pcf_pallas(
            shadowmap, sc.contiguous(), **kw, tile_h=config.tile_h,
            tile_w=config.tile_w, win=config.pcf_window, valid=valid,
            backend=kernel_backend(config))
    return compute_pcf(shadowmap, sc, **kw)


def _raw_factor(shadowmap, world_pos, view, config: EngineConfig,
                shadow_factor):
    """The shadow factor the raw-factor debug views (8, and 9's cell)
    show. The tap kernel's backends ("auto", "vmem") leave uncovered pixels
    at 1.0 (sky overwrites them in the lit frame), so the factor is
    recomputed ungated through the exact "packed" filter, as the JAX
    package does for its tap kernel."""
    if config.pcf_backend not in ("auto", "vmem"):
        return shadow_factor
    return _shadow_factor(shadowmap, world_pos, view,
                          config.replace(pcf_backend="packed"))


def _debug_switch(debug_view: int, final, attrs: SurfaceAttributes,
                  shadow_factor, reflection, case9=None,
                  shadow_factor_vis=None):
    """The SPEC_CONSTANTS switch of Base.frag:119-143 (forward) and
    BaseLighting.frag:237-253 (deferred when ``case9`` is given).
    ``debug_view`` is a host int (clipped to [0, 9]); only the chosen view
    is computed. ``shadow_factor_vis`` / ``case9`` are thunks."""

    def c(x):
        return (x[..., None] if x.ndim == 2 else x).broadcast_to(final.shape)

    dv = min(max(int(debug_view), 0), 9)
    if dv == 0:
        return final
    if dv == 8:
        return c(shadow_factor_vis() if shadow_factor_vis is not None
                 else shadow_factor)
    if dv == 9:
        return case9() if case9 is not None else final
    return c((None, attrs.base_color, attrs.metallic, attrs.roughness,
              attrs.normal, attrs.ao, attrs.vertex_color, reflection)[dv])


def _gbuffer_vis(gbuf: GBuffer, final, view, config: EngineConfig,
                 cube_atlas, shadow_factor):
    """BaseLighting.frag:42-145 GBufferVis - 3x3 contact sheet of the
    GBuffer (basecolor/metallic/roughness | normal/-/AO | black/refl/shadow),
    honoring the editor's reserved right/bottom bars via viewportInfo. The
    shadow cell shows the frame's factor, warped by the same contact-sheet
    sampling."""
    height, width = gbuf.depth.shape
    dev = final.device
    yy = (torch.arange(height, dtype=torch.float32, device=dev)[:, None]
          + 0.5) / height
    xx = (torch.arange(width, dtype=torch.float32, device=dev)[None, :]
          + 0.5) / width
    uv = torch.stack([xx.broadcast_to(height, width),
                      yy.broadcast_to(height, width)], -1)
    empty = view.viewport[2:4] / view.viewport[0:2]
    tile_uv = uv * 3.0 / (1.0 - empty)
    ix = torch.clamp((tile_uv[..., 0] * width).to(torch.int32), 0, width - 1)
    iy = torch.clamp((tile_uv[..., 1] * height).to(torch.int32), 0,
                     height - 1)
    idx = (iy * width + ix).long()

    def sample(img):
        return img.reshape(height * width, -1)[idx]

    ga = sample(gbuf.gbuffer_a)
    gb = sample(gbuf.gbuffer_b)
    gc = sample(gbuf.gbuffer_c)
    gd = sample(gbuf.gbuffer_d)

    base_color = gc[..., :3]
    metallic = pbr.saturate(gb[..., 0])
    roughness = torch.clamp_min(pbr.saturate(gb[..., 2]), 0.01)
    normal = pbr.normalize(ga[..., :3] * 2.0 - 1.0)
    ao = pbr.saturate(gc[..., 3])
    p = gd[..., :3]
    v = pbr.normalize(view.camera_pos - p)

    step = (1.0 - empty) / 3.0
    x = uv[..., 0]
    y = uv[..., 1]
    result = final
    white = torch.ones_like(final)

    def put(i, j, img):
        nonlocal result
        in_cell = ((x < step[0] * (i + 1)) & (x >= step[0] * i)
                   & (y < step[1] * (j + 1)) & (y >= step[1] * j))
        gutter = ((x > step[0] * (i + 1.0 - empty[0]))
                  | (y > step[1] * (j + 1.0 - empty[1])))
        val = torch.where(gutter[..., None], white, img)
        result = torch.where(in_cell[..., None], val, result)

    def c(x1):
        return x1[..., None].broadcast_to(final.shape)

    put(0, 0, gamma_correct(base_color))
    put(1, 0, c(metallic))
    put(2, 0, c(roughness))
    put(0, 1, normal)
    put(2, 1, c(ao))
    put(0, 2, torch.zeros_like(final))
    # (1, 2): raw mip-0 reflection.
    r = pbr.refract(v, normal, 1.0 / 1.52)
    refl = sample_cubemap_lod(
        cube_atlas, torch.zeros(x.shape, dtype=torch.int32, device=dev), r,
        torch.zeros(x.shape, dtype=torch.float32, device=dev),
        config.cubemap_size, quad=cube_atlas.shape[-1] % 13 != 0,
    )[..., :3] * 10.0
    put(1, 2, refl)
    put(2, 2, c(sample(shadow_factor[..., None])[..., 0]))
    return result


def resolve_lighting(gbuf: GBuffer, shadowmap, scene: GpuScene, view,
                     config: EngineConfig, tiled_points=None,
                     pallas_points=None, env_fetch=None,
                     enable_vis: bool = True):
    """BaseLighting.frag main(): unpack GBuffer, light, debug switch.
    Returns (color (H, W, 3), shadow factor (H, W)). ``env_fetch``: the
    merged environment tap (``_env_fetch``). ``enable_vis=False`` (a row
    band: the contact sheet samples other rows) shows the lit frame in
    debug view 9 instead of the GBufferVis sheet. Ablations (diagnostics):
    "nolight" replaces the shading by base colour x shadow factor (the
    merged tap still runs, so that the sky and background rows flow),
    "noswitch" returns the lit frame whatever the debug view."""
    base_color = gbuf.gbuffer_c[..., :3]
    metallic = pbr.saturate(gbuf.gbuffer_b[..., 0])
    roughness = torch.clamp_min(pbr.saturate(gbuf.gbuffer_b[..., 2]), 0.01)
    normal = gbuf.gbuffer_a[..., :3] * 2.0 - 1.0
    ao = pbr.saturate(gbuf.gbuffer_c[..., 3])
    emissive = gbuf.scene_color[..., :3]
    mask = gbuf.scene_color[..., 3]
    world_pos = gbuf.gbuffer_d[..., :3]

    shadow_factor = _shadow_factor(shadowmap, world_pos, view, config,
                                   valid=gbuf.depth < 1.0)
    if "nolight" in config.ablate:
        lit = {"final": base_color * shadow_factor[..., None],
               "reflection": torch.zeros_like(base_color)}
        if env_fetch is not None:
            # The JAX package's call, arguments as it passes them.
            env_fetch(normal, roughness)
    else:
        lit = shade_pixels(
            base_color, metallic, roughness, normal, ao, world_pos,
            shadow_factor, view, scene.cube_atlas, config.cubemap_size,
            cube_pair1=scene.cube_pair1, cube_const=scene.cube_const,
            tiled_points=tiled_points, pallas_points=pallas_points,
            env_fetch=env_fetch, ablate=config.ablate,
            refl_half=config.reflection_half,
        )
    final = gamma_correct(lit["final"] * mask[..., None])
    if int(view.debug_view) == 0 or "noswitch" in config.ablate:
        return final, shadow_factor

    def sf_vis():
        return _raw_factor(shadowmap, world_pos, view, config, shadow_factor)

    attrs = SurfaceAttributes(
        covered=gbuf.depth < 1.0,
        world_pos=world_pos,
        normal=pbr.normalize(normal),
        # The fullscreen rect's vertex colors are not reconstructible per
        # pixel; debug case 6 shows zeros, as in the JAX package.
        vertex_color=torch.zeros_like(base_color),
        base_color=gamma_correct(base_color),  # case 1 gamma-corrects
        metallic=metallic,
        roughness=roughness,
        ao=ao,
        emissive=emissive,
        mask=mask,
    )
    color = _debug_switch(
        view.debug_view, final, attrs, shadow_factor, lit["reflection"],
        case9=(lambda: _gbuffer_vis(gbuf, final, view, config,
                                    scene.cube_atlas, sf_vis()))
        if enable_vis else None,
        shadow_factor_vis=sf_vis)
    return color, shadow_factor


def forward_shade(attrs: SurfaceAttributes, shadowmap, scene: GpuScene,
                  view, config: EngineConfig, tiled_points=None,
                  pallas_points=None, env_fetch=None):
    """Base.frag main(): forward PBR with the case-0 ShadowFactor multiply
    (after the gamma curve, as the reference's forward shader does), or
    the chosen debug view (case 9 shows the lit forward pixel)."""
    shadow_factor = _shadow_factor(shadowmap, attrs.world_pos, view, config,
                                   valid=attrs.covered)
    lit = shade_pixels(
        attrs.base_color, attrs.metallic, attrs.roughness, attrs.normal,
        attrs.ao, attrs.world_pos, shadow_factor, view,
        scene.cube_atlas, config.cubemap_size, tiled_points=tiled_points,
        cube_pair1=scene.cube_pair1, cube_const=scene.cube_const,
        pallas_points=pallas_points, env_fetch=env_fetch,
        ablate=config.ablate, refl_half=config.reflection_half,
    )
    final = gamma_correct(lit["final"]) * shadow_factor[..., None]

    def sf_vis():
        return _raw_factor(shadowmap, attrs.world_pos, view, config,
                           shadow_factor)

    return _debug_switch(view.debug_view, final, attrs, shadow_factor,
                         lit["reflection"], shadow_factor_vis=sf_vis)


def _mat_vec(m, v):
    """(R, C) matrix applied to (..., C) vectors, as fp32 sums (no matmul:
    no TF32, no library call)."""
    return torch.sum(m * v[..., None, :], dim=-1)


def _sky_ray(scene, view, height, width, config: EngineConfig, y0: int = 0):
    """Closed-form skydome ray intersection: per-pixel ray vs the dome
    sphere. Returns (uv (H, W, 2), sky_depth (H, W), hit (H, W) - in
    front and within [0, 1] depth).

    The dome is a radius-``skydome_radius`` UV sphere centered at the
    origin (model-rotated); instead of rasterizing its ~576 triangles
    and gathering interpolated UVs, intersect the camera ray with the
    sphere analytically and derive the equirect UV from the hit
    direction - the exact infinite-tessellation limit of the mesh path
    (same UV convention as make_sphere). The rows are those of the band
    from viewport row ``y0``."""
    vp_h = config.height
    px, py = _pixel_grid(height, width, y0=y0, device=view.view_proj.device)
    nx = px / width * 2.0 - 1.0
    ny = py / vp_h * 2.0 - 1.0
    inv_vp = torch.linalg.inv(view.view_proj)
    # A point on each pixel ray (NDC z = 0.5; any z works).
    pt = torch.stack(
        [nx, ny, torch.full_like(nx, 0.5), torch.ones_like(nx)], -1
    )
    world_h = _mat_vec(inv_vp, pt)
    p0 = world_h[..., :3] / world_h[..., 3:4]
    d = pbr.normalize(p0 - view.camera_pos)

    o = view.camera_pos
    radius = scene.sky_params[0]
    b = torch.sum(o * d, dim=-1)
    c_s = torch.sum(o * o) - radius * radius
    disc = b * b - c_s
    s = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = -b - s
    t2 = -b + s
    t = torch.where(t1 > 1e-4, t1, t2)
    hit = (disc >= 0.0) & (t > 1e-4)
    p = o + t[..., None] * d

    # The dome rotates with the stage roll (model matrix); rotate the
    # lookup point back into dome-local space.
    inv_model = torch.linalg.inv(view.model)
    local = _mat_vec(inv_model[:3, :3], p)

    two_pi = 2.0 * math.pi
    u = torch.remainder(
        torch.atan2(local[..., 1], local[..., 0]) / two_pi
        + scene.sky_params[1],
        1.0,
    )
    v = torch.acos(torch.clamp(local[..., 2] / radius, -1.0, 1.0)) / math.pi
    uv = torch.stack([u, v], -1)

    # Dome depth (z/w through the camera projection) for the z-test.
    clip_z = torch.sum(view.view_proj[2, :3] * p, dim=-1) \
        + view.view_proj[2, 3]
    clip_w = torch.sum(view.view_proj[3, :3] * p, dim=-1) \
        + view.view_proj[3, 3]
    sky_depth = clip_z / torch.where(torch.abs(clip_w) > 1e-20, clip_w,
                                     torch.ones_like(clip_w))
    hit = hit & (sky_depth >= 0.0) & (sky_depth <= 1.0)
    return uv, sky_depth, hit


def _skydome_analytic(scene, view, depth, color, height, width,
                      config: EngineConfig, y0: int = 0):
    """Analytic skydome pass (ray + one sky tap + compose)."""
    uv, sky_depth, hit = _sky_ray(scene, view, height, width, config, y0)
    sky_mask = hit & (sky_depth < depth)
    args = (scene.sky_planes, uv.contiguous(), sky_mask,
            config.background_size)
    tap, _ovf = sample_base_window(*args, backend=kernel_backend(config))
    sky_rgb = gamma_correct(tap[..., :3])
    color = torch.where(sky_mask[..., None], sky_rgb, color)
    depth = torch.where(sky_mask, sky_depth, depth)
    return color, depth


def _skydome_mesh(scene, view, depth, color, height, width,
                  config: EngineConfig, y0: int = 0):
    """The skydome as rasterized geometry (the reference's own path: the
    dome mesh, ZeldaEngine.cpp:3682-3691): its triangles, two-sided,
    through kernel ``pair_raster`` with ids (``rasterize_visibility``
    under the "brute" route) and the frame's depth as the initial depth
    (LESS_OR_EQUAL against it), then the winner's interpolated uv and one
    mip-0 tap of the equirect. Returns (color, depth, the dome's pair
    stream or None, live triangles the compaction cap dropped). ``y0``:
    the row band of ``_raster_vis``."""
    sky_world = apply_mat4_point(view.model, scene.sky_pos)
    sky_clip = apply_mat4_h(view.view_proj, sky_world)
    sky_tri = scene.sky_tri.long()
    setup_sky = triangle_setup(sky_clip[sky_tri], width, config.height,
                               two_sided=True)
    depth_sky, tid_sky, pairs, covf = _raster_visibility(
        setup_sky, height, width, config, init_depth=depth, y0=y0)
    sky_mask = tid_sky >= 0
    bary, _ = interpolation_coeffs(setup_sky, tid_sky, height, width, y0=y0)
    corner_uv = scene.sky_uv[sky_tri[torch.clamp_min(tid_sky, 0).long()]]
    uv = (bary[..., 0:1] * corner_uv[..., 0, :]
          + bary[..., 1:2] * corner_uv[..., 1, :]
          + bary[..., 2:3] * corner_uv[..., 2, :])
    tap = sample_base(scene.sky_tex, torch.zeros_like(tid_sky), uv,
                      config.background_size, quad=True)
    sky_rgb = gamma_correct(tap[..., :3])
    color = torch.where(sky_mask[..., None], sky_rgb, color)
    depth = torch.where(sky_mask, depth_sky, depth)
    return color, depth, pairs, covf


def _screen_uv(height, width, config: EngineConfig, device, y0: int = 0):
    """The background rect's uv: pixel centres over the viewport, the rows
    those of the band from viewport row ``y0``."""
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None] \
        + 0.5
    if y0:  # (rows + 0.5) + y0, as the JAX package sums them
        yy = yy + y0
    yy = yy / config.height
    xx = (torch.arange(width, dtype=torch.float32, device=device)[None, :]
          + 0.5) / width
    return torch.stack([xx.broadcast_to(height, width),
                        yy.broadcast_to(height, width)], -1)


def _background(scene, depth, color, height, width, config: EngineConfig,
                y0: int = 0):
    """The background pass: a full-screen rect at z = 1 under
    LESS_OR_EQUAL (ZeldaEngine.cpp:3693-3699), one mip-0 tap of the
    background image per pixel the frame left at the far plane (kernel
    ``bilinear_tap`` on ``scene.bg_planes``)."""
    uv = _screen_uv(height, width, config, depth.device, y0)
    bg_mask = depth >= 1.0
    tap, _ovf = sample_base_window(scene.bg_planes, uv, bg_mask,
                                   config.background_size,
                                   backend=kernel_backend(config))
    bg_rgb = gamma_correct(tap[..., :3])
    return torch.where(bg_mask[..., None], bg_rgb, color)


def _env_fetch(scene, meta, config: EngineConfig, covered, sky_uv,
               sky_hit, bg_uv, cell: dict):
    """The merged environment tap of one pass (``reflection_color``'s
    ``env_fetch``): one row per pixel of ``scene.env_table``, the cube's
    for ``covered`` pixels, else the sky's where the dome is hit, else the
    background's. The sky and background texels land in ``cell`` for the
    compose passes."""

    def env_fetch(r, mips):
        refl, sky_rgba, bg_rgba = sample_env_merged(
            scene.env_table, meta.env_shapes, covered, r, mips,
            config.cubemap_size, sky_uv, sky_hit, bg_uv,
            config.background_size, config.background_size)
        cell.update(sky=sky_rgba, bg=bg_rgba, covered=covered)
        return refl

    return env_fetch


def _shadow_setup(scene, view, meta: SceneMeta, config: EngineConfig, world,
                  tri_vtx, no_meshlet=None):
    """The shadow casters' TriangleSetup at shadow-map resolution
    (two-sided: the Shadow pipelines disable culling), from the world
    positions of the pairs. CAMERA culling must NOT apply here - geometry
    behind the camera still casts shadows. The LIGHT frustum is a
    different matter: meshlets outside it cannot write the map (exact),
    and closed-mesh scenes can opt into the light-apex cone test
    (``shadow_cone_cull``). ``no_meshlet``: the triangles outside every
    meshlet, when the caller has them."""
    clip_sh = apply_mat4_h(view.shadow_space, world)
    sh_valid = scene.tri_valid
    if meta.has_meshlets:
        vis_sh = meshlet_cull(
            scene.meshlet_records,
            mat4_product(view.shadow_space, view.model),
            view.dir_lights[0, 0, :3], model=view.model,
            cone=config.shadow_cone_cull)
        if no_meshlet is None:
            no_meshlet = scene.tri_meshlet < 0
        sh_valid = sh_valid & (expand_meshlet_mask(
            vis_sh, torch.clamp_min(scene.tri_meshlet, 0)) | no_meshlet)
    return triangle_setup(
        clip_sh[tri_vtx],
        config.shadowmap_dim,
        config.shadowmap_dim,
        two_sided=True,
        valid_mask=sh_valid,
        depth_bias=(config.shadow_bias_constant, config.shadow_bias_slope),
    )


@torch.no_grad()
def render_shadow_band(scene: GpuScene, view, meta: SceneMeta,
                       config: EngineConfig, sy0: int, s_rows: int):
    """Rows [sy0, sy0 + s_rows) of the frame's shadow map (s_rows, D): the
    vertex stage of the pair positions, the casters' setup and the
    depth-only raster of the band (kernel ``pair_raster`` with
    ``y0_tiles``). What
    ``render_rows(shadow_rows=(sy0, s_rows, gather_fn))`` hands to
    ``gather_fn``; the multi-device path gathers the bands itself."""
    world = apply_mat4_point(view.model, scene.pair_pos)
    setup_sh = _shadow_setup(scene, view, meta, config, world,
                             scene.tri_vtx.long())
    band, _pairs, _covf = _raster_depth(
        _band_mask_setup(setup_sh, int(sy0), int(s_rows)),
        config.shadowmap_dim, config, y0=int(sy0), rows=int(s_rows))
    return band


def render_frame(
    scene: GpuScene,
    view,
    meta: SceneMeta,
    config: EngineConfig,
):
    """Render one frame on the device the scene lives on. Returns
    (image (H, W, 3) float32 in [0,1], aux)."""
    return render_rows(scene, view, meta, config)


@torch.no_grad()
def render_rows(
    scene: GpuScene,
    view,
    meta: SceneMeta,
    config: EngineConfig,
    y0=0,
    rows: Optional[int] = None,
    shadow_rows=None,
    full_frame: bool = True,
    shadowmap_override=None,
):
    """Row-band renderer: rasterize and shade pixel rows [y0, y0 + rows)
    of the viewport (the whole frame by default).

    The multi-device path (``parallel/tiles.py``) renders one band per
    device. ``full_frame=False`` marks a band: each pass keeps only the
    triangles whose bbox meets its rows (``_band_mask_setup``), K1/K2
    rasterize the tile rows that hold the band (``_band_tiles``), the
    light culls and the sky and
    background rays take the band's rows, and the GBufferVis contact sheet
    (debug view 9), which samples other rows, is off. ``shadow_rows=(sy0,
    s_rows, gather_fn)`` rasterizes only map rows [sy0, sy0 + s_rows) and
    builds the map with ``gather_fn(band)``; ``shadowmap_override`` takes an
    already-computed (D, D) shadow map instead of rasterizing one (the
    striped path renders several bands on one map). NDC-to-pixel mapping
    always uses the full viewport: ``rows`` only sizes the buffers."""
    if config.raster not in _RASTER_BACKENDS:
        raise ValueError(
            f"config.raster={config.raster!r}: expected one of "
            f"{_RASTER_BACKENDS}")
    if config.pcf_backend not in _PCF_BACKENDS:
        raise ValueError(
            f"config.pcf_backend={config.pcf_backend!r}: expected one of "
            f"{_PCF_BACKENDS}")
    if int(y0) != y0 or y0 < 0:
        raise ValueError(f"y0 must be a non-negative row, got {y0!r}")
    y0 = int(y0)
    dev = scene.pair_pos.device
    if config.raster == "cuda" and dev.type != "cuda":
        raise RuntimeError(
            "config.raster='cuda' needs the scene on the card; it is on "
            f"{dev}")
    band = not full_frame
    width = config.width
    height = config.height if rows is None else int(rows)
    vp_h = config.height

    # ---- point lights culled to screen tiles, once per pass.
    route = point_light_route(view, config)
    light_drops = torch.zeros((), dtype=torch.int32, device=dev)

    def culled_lights(attrs):
        """(tiled_points, pallas_points) of one pass: the point lights
        culled against that pass's own visible surface."""
        nonlocal light_drops
        tiled, pallas, drops = cull_lights(view, config, route, attrs, y0)
        if drops is not None:
            light_drops = light_drops + drops
        return tiled, pallas

    # ---- vertex stage (Base.vert / BaseInstanced.vert / Shadowmap*.vert)
    # Positions and normals through the model matrix in one transform.
    n_p = scene.pair_pos.shape[0]
    world, n1 = apply_mat4_point(view.model, torch.cat(
        [scene.pair_pos, pbr.normalize(scene.pair_nrm)])).split(n_p)
    if scene.rot_table.shape[0] <= 1:
        # No instance rotations anywhere (rot_table is just the identity
        # row): the per-pair (P, 3, 3) gather + product are the identity.
        n_world = n1
    else:
        n_world = _mat_vec(scene.rot_table[scene.pair_rot.long()], n1)
    clip = apply_mat4_h(view.view_proj, world)
    tri_vtx = scene.tri_vtx.long()
    tri_clip = clip[tri_vtx]

    # GPU-driven meshlet culling (frustum + backface cone): the per-frame
    # compacted 'indirect draw list' as a validity mask. The bounds are
    # transformed by ``model`` inside meshlet_cull, matching vp_model's
    # clip transform; the camera position is in world space.
    tri_valid = scene.tri_valid
    if meta.has_meshlets:
        tri_meshlet = scene.tri_meshlet
        no_meshlet = tri_meshlet < 0
        visible = meshlet_cull(
            scene.meshlet_records, mat4_product(view.view_proj, view.model),
            view.camera_pos, model=view.model)
        tri_valid = tri_valid & (expand_meshlet_mask(
            visible, torch.clamp_min(tri_meshlet, 0)) | no_meshlet)

    pair_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    # Live triangles the compaction caps dropped: 0 (a Python int, no
    # launch) until a pass compacts; they count in pair_overflow too, as
    # in the JAX package.
    compact_overflow = 0

    live_pairs = {}

    def dropped(name, pairs, covf):
        """Count a raster pass's drops; a pass without a pair stream (the
        "brute" route) drops nothing and has no live pair count."""
        nonlocal pair_overflow, compact_overflow
        if pairs is None:
            return
        pair_overflow = pair_overflow + pairs.overflow
        if isinstance(covf, torch.Tensor):
            pair_overflow = pair_overflow + covf
            compact_overflow = compact_overflow + covf
        live_pairs[name] = pairs.gbounds[1]

    # ---- 1. shadowmap pass (two-sided: cull disabled for Shadow pipelines)
    if shadowmap_override is not None:
        shadowmap = shadowmap_override.to(torch.float32).contiguous()
    elif config.enable_shadow:
        setup_sh = _shadow_setup(scene, view, meta, config, world, tri_vtx,
                                 no_meshlet if meta.has_meshlets else None)
        if shadow_rows is not None:
            sy0, s_rows, gather_fn = shadow_rows
            shadow_band, pairs_sh, covf_sh = _raster_depth(
                _band_mask_setup(setup_sh, sy0, s_rows),
                config.shadowmap_dim, config, y0=int(sy0), rows=int(s_rows))
            shadowmap = gather_fn(shadow_band)
        else:
            shadowmap, pairs_sh, covf_sh = _raster_depth(
                setup_sh, config.shadowmap_dim, config)
        shadowmap = shadowmap.contiguous()
        dropped("shadow", pairs_sh, covf_sh)
    else:
        shadowmap = torch.ones(
            (config.shadowmap_dim, config.shadowmap_dim),
            dtype=torch.float32, device=dev)

    # ---- merged environment tap (ops/envtap.py): one row fetch for
    # reflection, sky and background. The sky ray runs before the resolve
    # so that uncovered pixels' rows ride the reflection fetch.
    use_env = (config.env_merge and scene.env_table is not None
               and meta.env_shapes is not None
               and config.skydome_mode == "analytic")
    sky_on = meta.enable_skydome and config.enable_skydome
    bg_on = meta.enable_background and config.enable_background
    env_cells = []

    def env_fetch_of(covered):
        if not use_env:
            return None
        cell = {}
        env_cells.append(cell)
        return _env_fetch(scene, meta, config, covered, sky_uv, sky_hit,
                          bg_uv, cell)

    if use_env:
        if sky_on:
            sky_uv, sky_depth, sky_hit = _sky_ray(scene, view, height,
                                                  width, config, y0)
        else:
            sky_uv = torch.zeros((height, width, 2), dtype=torch.float32,
                                 device=dev)
            sky_hit = torch.zeros((height, width), dtype=torch.bool,
                                  device=dev)
        bg_uv = (_screen_uv(height, width, config, dev, y0) if bg_on
                 else None)

    # ---- 2. deferred scene -> GBuffer
    shadow_factor = None
    if meta.has_deferred:
        setup = triangle_setup(
            tri_clip, width, vp_h,
            two_sided=scene.tri_two_sided,
            valid_mask=tri_valid & scene.tri_deferred,
        )
        if band:
            setup = _band_mask_setup(setup, y0, height)
        depth_d, tid_d, attrs_d, pairs_d, covf_d = _visible_surface(
            scene, meta, config, setup, world, n_world, height, width, y0)
        if config.wireframe:
            attrs_d, depth_d, tid_d = _apply_wireframe(
                attrs_d, depth_d, tid_d, config)
        gbuf = pack_gbuffer(attrs_d, depth_d)
        # ---- 4a. deferred lighting (fullscreen, no depth test); the
        # lights are culled against the GBuffer's own visible surface.
        tiled_points, pallas_points = culled_lights(attrs_d)
        color, shadow_factor = resolve_lighting(
            gbuf, shadowmap, scene, view, config,
            tiled_points=tiled_points, pallas_points=pallas_points,
            env_fetch=env_fetch_of(attrs_d.covered), enable_vis=not band)
        dropped("gbuffer", pairs_d, covf_d)
    else:
        depth_d = torch.ones((height, width), dtype=torch.float32,
                             device=dev)
        tid_d = torch.full((height, width), -1, dtype=torch.int32,
                           device=dev)
        color = torch.zeros((height, width, 3), dtype=torch.float32,
                            device=dev)

    # ---- 4b. forward objects (z-test against the GBuffer depth); their
    # point lights are culled against their own visible surface.
    if meta.has_forward:
        setup_f = triangle_setup(
            tri_clip, width, vp_h,
            two_sided=scene.tri_two_sided,
            valid_mask=tri_valid & ~scene.tri_deferred,
        )
        if band:
            setup_f = _band_mask_setup(setup_f, y0, height)
        depth, tid_f, attrs_f, pairs_f, covf_f = _visible_surface(
            scene, meta, config, setup_f, world, n_world, height, width, y0,
            init_depth=depth_d)
        if config.wireframe:
            attrs_f, depth, tid_f = _apply_wireframe(
                attrs_f, depth, tid_f, config, fallback_depth=depth_d)
        tiled_f, pallas_f = culled_lights(attrs_f)
        fwd_color = forward_shade(
            attrs_f, shadowmap, scene, view, config,
            tiled_points=tiled_f, pallas_points=pallas_f,
            env_fetch=env_fetch_of(attrs_f.covered))
        color = torch.where((tid_f >= 0)[..., None], fwd_color, color)
        dropped("forward", pairs_f, covf_f)
    else:
        depth = depth_d
        tid_f = torch.full((height, width), -1, dtype=torch.int32,
                           device=dev)

    # The first pass whose merged tap ran holds the sky and background
    # texels (the deferred pass's; the forward pass's in forward-only
    # scenes, or where the deferred pass's shading skipped the tap).
    env_cell = next((c for c in env_cells if c), None)
    show_env = int(view.debug_view) == 0
    # ---- 4c. skydome (LESS_OR_EQUAL against current depth); skipped in
    # the debug views (ZeldaEngine.cpp:3682).
    if sky_on and show_env and "nosky" not in config.ablate:
        if env_cell is not None:
            # The sky texel rode the merged tap; compose it where the fetch
            # chose the sky row (uncovered pixels).
            sky_mask = sky_hit & (sky_depth < depth) & ~env_cell["covered"]
            sky_rgb = gamma_correct(env_cell["sky"][..., :3])
            color = torch.where(sky_mask[..., None], sky_rgb, color)
            depth = torch.where(sky_mask, sky_depth, depth)
        elif config.skydome_mode == "analytic":
            color, depth = _skydome_analytic(
                scene, view, depth, color, height, width, config, y0)
        else:
            color, depth, pairs_sky, covf_sky = _skydome_mesh(
                scene, view, depth, color, height, width, config, y0)
            dropped("skydome", pairs_sky, covf_sky)

    # ---- 4d. background (full-screen rect at z = 1, LESS_OR_EQUAL);
    # skipped in the debug views (ZeldaEngine.cpp:3693).
    if bg_on and show_env:
        if env_cell is not None:
            bg_mask = (depth >= 1.0) & ~env_cell["covered"]
            bg_rgb = gamma_correct(env_cell["bg"][..., :3])
            color = torch.where(bg_mask[..., None], bg_rgb, color)
        else:
            color = _background(scene, depth, color, height, width, config,
                                y0)

    aux = {
        "depth": depth,
        "shadowmap": shadowmap,
        "gbuffer_depth": depth_d,
        "tri_id": tid_d,
        "forward_tri_id": tid_f,
        # Beyond the JAX package's aux (device scalars; reading them
        # synchronises): live pairs dropped by the max_pairs caps and live
        # triangles dropped by the compaction caps (as in the JAX
        # package's pair_overflow), the latter alone (the int 0 when no
        # pass compacts), the live pair count of each raster pass that
        # bins pairs (none under the "brute" route: its passes have no
        # pair stream and add 0 to both overflows, as the JAX package's
        # jnp raster does), the deferred shadow factor, point lights
        # dropped by the per-tile cap (the JAX package's validation counter
        # "light_drops").
        "pair_overflow": pair_overflow,
        "compact_overflow": compact_overflow,
        "light_drops": light_drops,
        "live_pairs": live_pairs,
        "shadow_factor": shadow_factor,
    }
    if config.validation:
        # The validation-layer analogue (VK_LAYER_KHRONOS_validation +
        # debug messenger, ZeldaEngine.cpp:799-829): opt-in per-frame
        # counters for conditions that otherwise fail silently.
        val = {
            "nonfinite_color": torch.sum(
                ~torch.isfinite(color)).to(torch.int32),
            "nonfinite_shadowmap": torch.sum(
                ~torch.isfinite(shadowmap)).to(torch.int32),
            "light_drops": light_drops.to(torch.int32),
            # Live pairs dropped by the max_pairs capacity slices.
            "pair_overflow": pair_overflow,
        }
        if meta.has_deferred:
            val["oversized_tris"] = count_oversized(
                setup, width, config.height, config.tile_h, config.tile_w,
                config.pair_expand)
        aux["validation"] = val
    color = torch.clamp(color, 0.0, 1.0)
    return color, aux
