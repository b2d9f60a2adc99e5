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
full-frame, single-device frame runs: vertex stage -> shadow raster
(kernel ``pair_raster``) -> fused GBuffer raster (``pair_raster_fused``)
-> materials (per-combo constants + one mip-pair atlas fetch of the
varying channels) -> 25-tap PCF (``pcf_taps``; or an opt-in backend:
``pcf_window``, the window tables of ``pcf_window_table`` /
``pcf_window2d_table``, or a plain filter) -> directional light + point
lights culled to screen tiles (``point_lights``; or the plain loop /
tiled loop) -> cube reflection (constant-lod table, half-resolution
mip-pair cube or quad atlas) -> forward objects, z-tested against the
GBuffer depth (``pair_raster_fused`` with an initial depth, their own
light cull and PCF) -> analytic skydome (``bilinear_tap``), or one of the
debug views 1-9 instead of the lit frame. Everything else the JAX
package's frame can do raises ``NotImplementedError`` naming its
``ROADMAP.md`` item; nothing is silently served by another path.

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
    apply_mat4_h, apply_mat4_point)
from zeldaengine_tpu_torch.ops import pbr
from zeldaengine_tpu_torch.ops.lighting import (
    cull_point_lights_tiled, shade_pixels)
from zeldaengine_tpu_torch.ops.pcf_cuda import compute_pcf_vmem
from zeldaengine_tpu_torch.ops.pcf_window import compute_pcf_pallas
from zeldaengine_tpu_torch.ops.rasterize import _pixel_grid, triangle_setup
from zeldaengine_tpu_torch.ops.rasterize_cuda import (
    build_pairs,
    fused_extra_width,
    rasterize_pairs,
    rasterize_pairs_fused,
)
from zeldaengine_tpu_torch.ops.shadow import (
    compute_pcf,
    compute_pcf_half,
    compute_pcf_packed,
    compute_pcf_packed_roll,
    compute_pcf_window_roll,
    compute_shadow_coord,
)
from zeldaengine_tpu_torch.ops.texture import sample_cubemap_lod
from zeldaengine_tpu_torch.ops.window_tap import sample_base_window
from zeldaengine_tpu_torch.passes.gbuffer import (
    GBuffer,
    SurfaceAttributes,
    pack_gbuffer,
    surface_attributes_from_planes,
)
from zeldaengine_tpu_torch.scene.scenebuild import GpuScene, SceneMeta

_RASTER_BACKENDS = ("auto", "cuda", "torch")
_PCF_BACKENDS = ("auto", "vmem", "exact", "packed", "packed_b",
                 "packed_roll", "window_roll", "half", "half_nearest",
                 "half_wr", "pallas")


def unported_reasons(scene: GpuScene, view, meta: SceneMeta,
                     config: EngineConfig, full_frame: bool = True) -> list:
    """Every reason this configuration is outside the ported slice, each
    naming the ``ROADMAP.md`` item that will bring it."""
    why = []

    def no(cond, what, item):
        if cond:
            why.append(f"{what} is not ported yet (ROADMAP.md {item})")

    no(meta.has_meshlets, "meshlet culling (meta.has_meshlets)",
       "A4: ops/culling.py")
    no(config.env_merge, "env_merge", "A4: ops/envtap.py")
    no(config.wireframe, "wireframe", "A5: passes/frame.py _apply_wireframe")
    no(config.skydome_mode != "analytic",
       f"skydome_mode={config.skydome_mode!r}",
       "A5: passes/frame.py _skydome_mesh")
    no(config.enable_background, "enable_background (the background pass)",
       "A5: passes/frame.py background")
    no(config.validation, "validation counters",
       "A5: passes/frame.py validation")
    no(config.compact_tris is not None
       or config.compact_tris_shadow is not None,
       "live-triangle compaction (compact_tris / compact_tris_shadow)",
       "A2: compact_setup")
    no(config.pair_align, "pair_align", "A2: build_pairs align")
    no(config.raster_early_out, "raster_early_out",
       "B: K1 occlusion early-out")
    no(config.reflection_half, "reflection_half",
       "A4: ops/lighting.py::reflection_color half")
    no(config.ablate != "", f"ablate={config.ablate!r}",
       "A5: passes/frame.py ablations")
    no(not full_frame, "row bands (full_frame=False)",
       "A8: parallel/tiles.py")
    no(config.pcf_backend not in _PCF_BACKENDS,
       f"pcf_backend={config.pcf_backend!r} (a PCF variant without a "
       "kernel)", "A9: ops/shadow.py variants")
    return why


def _pad_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _fused_extra(scene, n_t: int, world, n_world, need_uv: bool = True,
                 need_combo: bool = True):
    """Per-triangle fused-record payload (T, fused_extra_width(flags)):
    material-combo id (as a float value, elided when every triangle
    shares one combo) + 3 corners x (uv2 [elided for textureless
    flat-normal scenes], color3, world-pos3, world-normal3). O(T) work
    once per frame instead of a per-PIXEL record gather."""
    static = (scene.pair_static[:, :5] if need_uv
              else scene.pair_static[:, 2:5])
    pair_all = torch.cat([static, world, n_world], dim=1)  # (P, 11 or 9)
    cw = pair_all.shape[1]
    tv = scene.tri_vtx[:n_t].long()
    corners = pair_all[tv].reshape(n_t, 3 * cw)
    if not need_combo:
        return corners
    mat = scene.tri_meta[:n_t, 3].long()
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


def _raster_vis_fused(setup, extra, height, width, config: EngineConfig,
                      meta=None, init_depth=None):
    """Fused visibility raster + attribute interpolation: returns
    (depth, tid, attr planes (ATTR_CH, H, W), the pair stream). The frame is
    padded to whole tiles (1080 rows -> 1088 at 64-row tiles) and cropped
    back; ``init_depth`` (H, W) is padded with the far plane."""
    need_uv, need_combo, combo_const = (
        _fused_flags(meta) if meta is not None else (True, True, 0.0))
    n_extra = fused_extra_width(need_uv, need_combo)
    ph = _pad_up(height, config.tile_h)
    pw = _pad_up(width, max(config.tile_w, 128))
    assert extra.shape[1] == n_extra, (extra.shape, n_extra)
    has_z = 1 if config.raster_zsort else 0
    ysr = config.sub_rows if config.raster_ysort else None
    if ysr and ph > height:
        setup = _span_padded_rows(setup, height, ph)
    pairs = build_pairs(setup, pw, ph, config.tile_h, config.tile_w,
                        expand=config.pair_expand,
                        extra=extra, max_pairs=config.max_pairs,
                        sort_z=config.raster_zsort,
                        align=config.pair_align,
                        ysort_sub_rows=ysr,
                        gather_chunks=config.pair_gather_chunks,
                        gather_pack=config.pair_gather_pack,
                        center_cull=config.subpixel_cull)
    kw = dict(tile_h=config.tile_h, tile_w=config.tile_w,
              sub_rows=config.sub_rows, texture_size=config.texture_size,
              y_row=(12 + n_extra + has_z) if ysr else -1,
              need_uv=need_uv, has_combo=need_combo,
              combo_const=combo_const)
    if init_depth is not None and (ph != height or pw != width):
        init_depth = F.pad(init_depth, (0, pw - width, 0, ph - height),
                           value=1.0)
    depth, tid, planes = rasterize_pairs_fused(
        pairs, ph, pw, init_depth=init_depth, backend=config.raster, **kw)
    return (depth[:height, :width], tid[:height, :width],
            planes[:, :height, :width], pairs)


def _raster_depth(setup, dim, config: EngineConfig):
    """The shadow map: depth-only pair raster at shadowmap resolution,
    padded to whole shadow tiles (the span of a triangle reaching the map's
    bottom edge is extended over the padded rows, as in
    ``_raster_vis_fused``) and cropped back."""
    s_th = config.shadow_tile_h or config.tile_h
    s_tw = config.shadow_tile_w or config.tile_w
    ph = _pad_up(dim, s_th)
    pw = _pad_up(dim, s_tw)
    has_z = 1 if config.raster_zsort else 0
    ysr = config.sub_rows if config.raster_ysort else None
    if ysr and ph > dim:
        setup = _span_padded_rows(setup, dim, ph)
    pairs = build_pairs(setup, pw, ph, s_th, s_tw,
                        expand=config.pair_expand_shadow,
                        max_pairs=config.max_pairs_shadow,
                        sort_z=config.raster_zsort,
                        align=config.pair_align,
                        ysort_sub_rows=ysr,
                        gather_chunks=config.pair_gather_chunks,
                        gather_pack=config.pair_gather_pack,
                        center_cull=config.subpixel_cull)
    kw = dict(tile_h=s_th, tile_w=s_tw, sub_rows=config.sub_rows,
              depth_only=True, y_row=(12 + has_z) if ysr else -1)
    depth = rasterize_pairs(pairs, ph, pw, backend=config.raster, **kw)
    return depth[:dim, :dim], pairs


def _shadow_factor(shadowmap, world_pos, view, config: EngineConfig,
                   valid=None):
    """The deferred shadow factor through ``config.pcf_backend``: "auto" /
    "vmem" the tap kernel; "packed" / "packed_b", "packed_roll",
    "window_roll" exact row- or window-table filters (the last two over
    the tables of the window-table kernels, on maps whose width is a
    multiple of 128); "half*" half resolution + upsample; "pallas" the
    windowed kernel (approximate by design); "exact" and every fallback
    the plain 25-gather filter."""
    sc = compute_shadow_coord(view.shadow_space, world_pos)
    kw = dict(radius=config.pcf_radius, scale=config.pcf_scale,
              bias=config.shadow_bias)
    backend = config.pcf_backend
    dim_ok = config.shadowmap_dim % 128 == 0
    if backend in ("half", "half_nearest", "half_wr") and sc.ndim == 3:
        return compute_pcf_half(
            shadowmap, sc, **kw,
            upsample="nearest" if backend == "half_nearest" else "linear",
            inner="window_roll" if backend == "half_wr" else "packed",
            backend=config.raster)
    if backend == "window_roll" and dim_ok:
        return compute_pcf_window_roll(shadowmap, sc, **kw,
                                       backend=config.raster)
    if backend == "packed_roll" and dim_ok:
        return compute_pcf_packed_roll(shadowmap, sc, **kw,
                                       backend=config.raster)
    if backend in ("auto", "vmem") and sc.ndim == 3:
        # The tap kernel: equal to compute_pcf at every in-range pixel.
        # Uncovered pixels (whose world_pos is the GBuffer default,
        # overwritten by sky downstream) read 1.0.
        sc = sc.contiguous()
        sf, _overflow = compute_pcf_vmem(shadowmap, sc, active=valid,
                                         backend=config.raster, **kw)
        if valid is not None:
            sf = torch.where(valid, sf, torch.ones_like(sf))
        return sf
    if backend in ("packed", "packed_b"):
        return compute_pcf_packed(shadowmap, sc, **kw,
                                  batch_rows=backend == "packed_b")
    if backend == "pallas" and sc.ndim == 3:
        # One kernel launch from the coordinate to the factor; the last
        # tiles read zero coordinates past the frame, as padding would.
        return compute_pcf_pallas(
            shadowmap, sc.contiguous(), **kw, tile_h=config.tile_h,
            tile_w=config.tile_w, win=config.pcf_window, valid=valid,
            backend=config.raster)
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
                     pallas_points=None):
    """BaseLighting.frag main(): unpack GBuffer, light, debug switch.
    Returns (color (H, W, 3), shadow factor (H, W))."""
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
    lit = shade_pixels(
        base_color, metallic, roughness, normal, ao, world_pos,
        shadow_factor, view, scene.cube_atlas, config.cubemap_size,
        cube_pair1=scene.cube_pair1, cube_const=scene.cube_const,
        tiled_points=tiled_points, pallas_points=pallas_points,
    )
    final = gamma_correct(lit["final"] * mask[..., None])
    if int(view.debug_view) == 0:
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
        case9=lambda: _gbuffer_vis(gbuf, final, view, config,
                                   scene.cube_atlas, sf_vis()),
        shadow_factor_vis=sf_vis)
    return color, shadow_factor


def forward_shade(attrs: SurfaceAttributes, shadowmap, scene: GpuScene,
                  view, config: EngineConfig, tiled_points=None,
                  pallas_points=None):
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
        pallas_points=pallas_points,
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


def _sky_ray(scene, view, height, width, config: EngineConfig):
    """Closed-form skydome ray intersection: per-pixel ray vs the dome
    sphere. Returns (uv (H, W, 2), sky_depth (H, W), hit (H, W) - in
    front and within [0, 1] depth).

    The dome is a radius-``skydome_radius`` UV sphere centered at the
    origin (model-rotated); instead of rasterizing its ~576 triangles
    and gathering interpolated UVs, intersect the camera ray with the
    sphere analytically and derive the equirect UV from the hit
    direction - the exact infinite-tessellation limit of the mesh path
    (same UV convention as make_sphere)."""
    vp_h = config.height
    px, py = _pixel_grid(height, width, device=view.view_proj.device)
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
                      config: EngineConfig):
    """Analytic skydome pass (ray + one sky tap + compose)."""
    uv, sky_depth, hit = _sky_ray(scene, view, height, width, config)
    sky_mask = hit & (sky_depth < depth)
    args = (scene.sky_planes, uv.contiguous(), sky_mask,
            config.background_size)
    tap, _ovf = sample_base_window(*args, backend=config.raster)
    sky_rgb = gamma_correct(tap[..., :3])
    color = torch.where(sky_mask[..., None], sky_rgb, color)
    depth = torch.where(sky_mask, sky_depth, depth)
    return color, depth


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
    full_frame: bool = True,
    shadowmap_override=None,
):
    """The frame. Row bands (``y0``/``rows``/``full_frame=False``, the
    multi-device path of the JAX package) are not ported: only the full
    frame renders. ``shadowmap_override`` takes an already-computed
    (D, D) shadow map instead of rasterizing one."""
    if config.raster not in _RASTER_BACKENDS:
        raise ValueError(
            f"config.raster={config.raster!r}: expected one of "
            f"{_RASTER_BACKENDS}")
    band = (not full_frame) or y0 != 0 or (
        rows is not None and rows != config.height)
    why = unported_reasons(scene, view, meta, config, full_frame=not band)
    if why:
        raise NotImplementedError("; ".join(why))
    dev = scene.pair_pos.device
    if config.raster == "cuda" and dev.type != "cuda":
        raise RuntimeError(
            "config.raster='cuda' needs the scene on the card; it is on "
            f"{dev}")
    width = config.width
    height = config.height

    # ---- point lights culled to screen tiles. The JAX package's "auto"
    # takes the point-light kernel on an accelerator only; the port's
    # device is the card, so "auto" takes it on every device (the plain
    # version serves CPU tensors). "unroll" is the plain loop, or the
    # tiled loop once the table reaches tiled_lights_min slots.
    n_slots = view.point_lights.shape[0]
    use_kernel_points = (
        config.point_light_kernel in ("pallas", "auto")
        and n_slots >= config.point_kernel_min and width % 128 == 0)
    use_tiled = (not use_kernel_points
                 and n_slots >= config.tiled_lights_min
                 and width % config.light_tile_w == 0)
    light_drops = torch.zeros((), dtype=torch.int32, device=dev)

    def culled_lights(attrs):
        """(tiled_points, pallas_points) of one pass: the point lights
        culled against that pass's own visible surface."""
        nonlocal light_drops
        if use_kernel_points:
            tile_h, tile_w = config.point_block_h, 128
        elif use_tiled:
            tile_h, tile_w = config.light_tile_h, config.light_tile_w
        else:
            return None, None
        tile_idx, tile_cnt, drops = cull_point_lights_tiled(
            view.point_lights, int(view.lights_count[1]), view, width,
            height, tile_h, tile_w, config.max_tile_lights,
            vp_h=config.height, world_pos=attrs.world_pos,
            covered=attrs.covered)
        light_drops = light_drops + drops
        if use_kernel_points:
            return None, (tile_idx, tile_cnt, tile_h, config.raster)
        return (tile_idx, tile_cnt, tile_h, tile_w), None

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

    pair_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    live_pairs = {}
    # ---- 1. shadowmap pass (two-sided: cull disabled for Shadow pipelines)
    if shadowmap_override is not None:
        shadowmap = shadowmap_override.to(torch.float32).contiguous()
    elif config.enable_shadow:
        clip_sh = apply_mat4_h(view.shadow_space, world)
        # CAMERA culling must NOT apply here - geometry behind the camera
        # still casts shadows.
        setup_sh = triangle_setup(
            clip_sh[tri_vtx],
            config.shadowmap_dim,
            config.shadowmap_dim,
            two_sided=True,
            valid_mask=scene.tri_valid,
            depth_bias=(config.shadow_bias_constant,
                        config.shadow_bias_slope),
        )
        shadowmap, pairs_sh = _raster_depth(
            setup_sh, config.shadowmap_dim, config)
        shadowmap = shadowmap.contiguous()
        pair_overflow = pair_overflow + pairs_sh.overflow
        live_pairs["shadow"] = pairs_sh.gbounds[1]
    else:
        shadowmap = torch.ones(
            (config.shadowmap_dim, config.shadowmap_dim),
            dtype=torch.float32, device=dev)

    # ---- 2. deferred scene -> GBuffer
    shadow_factor = None
    if meta.has_deferred:
        setup = triangle_setup(
            tri_clip, width, height,
            two_sided=scene.tri_two_sided,
            valid_mask=scene.tri_valid & scene.tri_deferred,
        )
        f_uv, f_combo, _ = _fused_flags(meta)
        extra = _fused_extra(scene, setup.edge.shape[0], world, n_world,
                             need_uv=f_uv, need_combo=f_combo)
        depth_d, tid_d, planes_d, pairs_d = _raster_vis_fused(
            setup, extra, height, width, config, meta=meta)
        attrs_d = surface_attributes_from_planes(
            scene, planes_d, config, var_ch=meta.tex_channels,
            flat_normal=meta.flat_normal)
        gbuf = pack_gbuffer(attrs_d, depth_d)
        # ---- 4a. deferred lighting (fullscreen, no depth test); the
        # lights are culled against the GBuffer's own visible surface.
        tiled_points, pallas_points = culled_lights(attrs_d)
        color, shadow_factor = resolve_lighting(
            gbuf, shadowmap, scene, view, config,
            tiled_points=tiled_points, pallas_points=pallas_points)
        pair_overflow = pair_overflow + pairs_d.overflow
        live_pairs["gbuffer"] = pairs_d.gbounds[1]
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
            tri_clip, width, height,
            two_sided=scene.tri_two_sided,
            valid_mask=scene.tri_valid & ~scene.tri_deferred,
        )
        f_uv, f_combo, _ = _fused_flags(meta)
        extra_f = _fused_extra(scene, setup_f.edge.shape[0], world, n_world,
                               need_uv=f_uv, need_combo=f_combo)
        depth, tid_f, planes_f, pairs_f = _raster_vis_fused(
            setup_f, extra_f, height, width, config, meta=meta,
            init_depth=depth_d)
        attrs_f = surface_attributes_from_planes(
            scene, planes_f, config, var_ch=meta.tex_channels,
            flat_normal=meta.flat_normal)
        tiled_f, pallas_f = culled_lights(attrs_f)
        fwd_color = forward_shade(
            attrs_f, shadowmap, scene, view, config,
            tiled_points=tiled_f, pallas_points=pallas_f)
        color = torch.where((tid_f >= 0)[..., None], fwd_color, color)
        pair_overflow = pair_overflow + pairs_f.overflow
        live_pairs["forward"] = pairs_f.gbounds[1]
    else:
        depth = depth_d
        tid_f = torch.full((height, width), -1, dtype=torch.int32,
                           device=dev)

    # ---- 4c. skydome (LESS_OR_EQUAL against current depth); skipped in
    # the debug views (ZeldaEngine.cpp:3682).
    if (meta.enable_skydome and config.enable_skydome
            and int(view.debug_view) == 0):
        color, depth = _skydome_analytic(
            scene, view, depth, color, height, width, config)

    aux = {
        "depth": depth,
        "shadowmap": shadowmap,
        "gbuffer_depth": depth_d,
        "tri_id": tid_d,
        "forward_tri_id": tid_f,
        # Beyond the JAX package's aux (device scalars; reading them
        # synchronises): live pairs dropped by the max_pairs caps, the
        # live pair count of each raster pass, the deferred shadow factor,
        # point lights dropped by the per-tile cap (the JAX package's
        # validation counter "light_drops").
        "pair_overflow": pair_overflow,
        "light_drops": light_drops,
        "live_pairs": live_pairs,
        "shadow_factor": shadow_factor,
    }
    color = torch.clamp(color, 0.0, 1.0)
    return color, aux
