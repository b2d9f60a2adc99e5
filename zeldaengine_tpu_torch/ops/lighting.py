"""The shared lighting core of Base.frag:73-117 / BaseLighting.frag:180-235.

Direct (Disney diffuse + GGX specular per light), indirect (Lambert * AO *
0.3 * shadow), and IBL reflection (refract-vector cubemap lookup, Lazarov
env BRDF, x10 intensity). Vectorized over pixel grids; the per-light loops
are plain Python loops over the light tables. Point lights can instead be
culled to screen tiles (``cull_point_lights_tiled``) and shaded per tile,
by the plain tiled loop (``_point_lighting_tiled``) or by kernel
``point_lights`` (``ops/lighting_cuda.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from zeldaengine_tpu_torch.ops import pbr
from zeldaengine_tpu_torch.ops.lighting_cuda import point_lighting
from zeldaengine_tpu_torch.ops.texture import (
    cube_direction_to_face_uv, sample_cubemap_lod)


def direct_lighting(
    diffuse_color,  # (..., 3) BaseColor * (1 - Metallic)
    roughness,  # (...,)
    n,  # (..., 3) shading normal (normalized)
    p,  # (..., 3) world position
    v,  # (..., 3) view vector (normalized, toward camera)
    ndotv,  # (...,)
    shadow_factor,  # (...,)
    dir_lights,  # (Ld, 4, 4) packed lights
    n_dir,  # int (or 0-d integer tensor)
    point_lights,  # (Lp, 4, 4)
    n_point,  # int
    spot_lights=None,  # (Ls, 4, 4) or None
    n_spot=None,  # int
    tiled_points=None,  # (tile_idx, tile_cnt, tile_h, tile_w) or None
    pallas_points=None,  # (tile_idx, tile_cnt, block_h, backend) or None
):
    """Sum of the light loops (directional applies the shadow factor,
    point lights do not - Base.frag:86 vs :98).

    Spot lights are shaded here even though the reference *declares* but
    never loops ``spotLights[16]`` (Base.frag:15) - a strict superset:
    point-light falloff x a smoothstep cone (cosInner/cosOuter carried in
    the light's ExtraData.xy; defaults 25deg/30deg when unset).

    Each table is walked in ascending slot order up to its live count. The
    JAX package evaluates every capacity slot and multiplies dead slots by
    0.0; adding that exact zero changes nothing, so dead slots are simply
    not evaluated here.

    ``pallas_points`` sends the point lights through kernel
    ``point_lights`` (culled lists of (block_h, 128) blocks, accumulated
    onto the directional partial sum); ``tiled_points`` through the plain
    tiled loop, whose sum is added after.
    """

    def bxdf_times_radiance(light, kind: str):
        if kind == "dir":
            l_dir = pbr.normalize(light[2, :3]).broadcast_to(p.shape)
        else:
            l_dir = pbr.normalize(light[0, :3] - p)
        h = pbr.normalize(v + l_dir)
        ldoth = pbr.saturate(torch.sum(l_dir * h, -1))
        ndoth = pbr.saturate(torch.sum(n * h, -1))
        ndotl = pbr.saturate(torch.sum(n * l_dir, -1))
        dif, spec = pbr.default_lit_bxdf(
            diffuse_color, roughness, ldoth, ndotv, ndotl, ndoth
        )
        if kind == "dir":
            radiance = pbr.apply_directional_light(
                light[2, :3].broadcast_to(p.shape),
                light[1, :3],
                light[1, 3].broadcast_to(ndotl.shape),
                n,
            )
        else:
            radiance = pbr.apply_point_light(
                light[0, :3],
                light[1, :3],
                light[1, 3].broadcast_to(ndotl.shape),
                light[2, 3].broadcast_to(ndotl.shape),
                p,
                n,
            )
            if kind == "spot":
                radiance = radiance * pbr.spot_cone_factor(
                    light[0, :3], light[2, :3], light[3, 0], light[3, 1], p
                )[..., None]
        return radiance * (dif + spec[..., None])

    def live(table, count):
        return range(min(int(count), table.shape[0]))

    acc = torch.zeros_like(diffuse_color)
    for i in live(dir_lights, n_dir):
        acc = acc + (bxdf_times_radiance(dir_lights[i], "dir")
                     * shadow_factor[..., None])
    if pallas_points is not None:
        tile_idx, tile_cnt, block_h, backend = pallas_points
        acc = point_lighting(
            acc.contiguous(), diffuse_color.contiguous(),
            roughness.contiguous(), n.contiguous(), p.contiguous(),
            v.contiguous(), ndotv.contiguous(), point_lights, tile_idx,
            tile_cnt, block_h=block_h, backend=backend)
    elif tiled_points is not None:
        tile_idx, tile_cnt, lt_h, lt_w = tiled_points
        acc = acc + _point_lighting_tiled(
            diffuse_color, roughness, n, p, v, ndotv, point_lights,
            tile_idx, tile_cnt, lt_h, lt_w)
    else:
        for i in live(point_lights, n_point):
            acc = acc + bxdf_times_radiance(point_lights[i], "point")
    if spot_lights is not None:
        for i in live(spot_lights, n_spot):
            acc = acc + bxdf_times_radiance(spot_lights[i], "spot")
    return acc


def cull_point_lights_tiled(
    point_lights,  # (L, 4, 4)
    n_point: int,
    view,  # ViewState (view_proj, camera_fov)
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    k_max: int,
    y0=0.0,
    vp_h: Optional[int] = None,
    world_pos=None,  # (H, W, 3) visible-surface positions (depth bounds)
    covered=None,  # (H, W) bool: pixels whose world_pos is real
):
    """Per-screen-tile point-light lists: conservative projected-sphere vs
    tile-rect binning, depth bounds, and the first ``k_max`` hits of each
    tile in ascending light order.

    The reference carries a 512-point-light capacity (ZeldaEngine.cpp:85)
    and loops all of them per pixel (BaseLighting.frag:182-207); this is
    the tiled-deferred culling that makes that capacity usable. ``y0`` /
    ``height`` select a row band of a ``vp_h``-row viewport; the tile grid
    covers ceil(height / tile_h) rows.

    ``world_pos`` / ``covered`` add depth bounds: each tile's covered
    pixels bound a world-space AABB, and a light is kept only if its
    sphere reaches that box. A tile with no covered pixel keeps no light.

    Returns (tile_idx (Ty, Tx, min(K, L)) int32, tile_cnt (Ty, Tx) int32,
    drops () int32: hits beyond the per-tile cap, summed over tiles).
    """
    vp_h = height if vp_h is None else vp_h
    pos = point_lights[:, 0, :3]
    radius = torch.clamp_min(point_lights[:, 2, 3], 0.0)
    vp = view.view_proj
    # pos @ view_proj[:3, :3].T + view_proj[:3, 3], as fp32 multiply-adds
    # in index order (no matmul: no TF32 on the card).
    clip = (pos[:, 0, None] * vp[:3, 0] + pos[:, 1, None] * vp[:3, 1]
            + pos[:, 2, None] * vp[:3, 2]) + vp[:3, 3]
    w = (pos[:, 0] * vp[3, 0] + pos[:, 1] * vp[3, 1]
         + pos[:, 2] * vp[3, 2]) + vp[3, 3]
    safe_w = torch.clamp_min(torch.abs(w), 1e-6)
    signed_w = torch.where(w > 0, safe_w, -safe_w)
    cx = (clip[:, 0] / signed_w * 0.5 + 0.5) * width
    cy = (clip[:, 1] / signed_w * 0.5 + 0.5) * vp_h
    # Conservative screen radius from the projection's focal length; the
    # aspect and y pixel scale are the full viewport's.
    f = 1.0 / torch.tan(torch.deg2rad(view.camera_fov) * 0.5)
    aspect = width / vp_h
    rx = radius * (f / aspect) / safe_w * 0.5 * width
    ry = radius * f / safe_w * 0.5 * vp_h
    # Behind or crossing the camera plane: kept everywhere.
    near_cam = w < radius + 0.1
    zero = torch.zeros_like(cx)
    lx0 = torch.where(near_cam, zero, cx - rx)
    lx1 = torch.where(near_cam, zero + float(width), cx + rx)
    ly0 = torch.where(near_cam, zero, cy - ry)
    ly1 = torch.where(near_cam, zero + float(vp_h), cy + ry)

    dev = point_lights.device
    n_ty = -(-height // tile_h)
    n_tx = width // tile_w
    tx = torch.arange(n_tx, dtype=torch.float32, device=dev) * tile_w
    ty = (torch.arange(n_ty, dtype=torch.float32, device=dev) * tile_h
          + float(y0))
    ox = (lx1[:, None] >= tx[None, :]) & (lx0[:, None] <= tx[None, :] + tile_w)
    oy = (ly1[:, None] >= ty[None, :]) & (ly0[:, None] <= ty[None, :] + tile_h)
    live = torch.arange(point_lights.shape[0], device=dev) < int(n_point)
    mask = oy[:, :, None] & ox[:, None, :] & live[:, None, None]  # (L,Ty,Tx)

    if world_pos is not None:
        big = 3.0e38
        pad_rows = n_ty * tile_h - world_pos.shape[0]
        cov = covered if covered is not None else torch.ones(
            world_pos.shape[:2], dtype=torch.bool, device=dev)
        wp = world_pos
        if pad_rows:
            wp = torch.nn.functional.pad(wp, (0, 0, 0, 0, 0, pad_rows))
            cov = torch.nn.functional.pad(cov, (0, 0, 0, pad_rows))
        p5 = wp.reshape(n_ty, tile_h, n_tx, tile_w, 3)
        c4 = cov.reshape(n_ty, tile_h, n_tx, tile_w)
        c5 = c4[..., None]
        lo_b = torch.where(c5, p5, big).amin(dim=(1, 3))  # (Ty, Tx, 3)
        hi_b = torch.where(c5, p5, -big).amax(dim=(1, 3))
        any_cov = c4.any(dim=3).any(dim=1)
        pc = pos[:, None, None, :]
        gap = torch.clamp_min(
            torch.maximum(lo_b[None] - pc, pc - hi_b[None]), 0.0)
        dist2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]
                 + gap[..., 2] * gap[..., 2])
        reach = dist2 <= (radius * radius)[:, None, None]
        mask = mask & reach & any_cov[None]
    mask = torch.movedim(mask, 0, -1)  # (Ty, Tx, L)
    # Hits first, each group in ascending light order (stable), capped.
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
    tile_idx = order[..., :k_max].to(torch.int32).contiguous()
    hits = mask.sum(-1)
    tile_cnt = torch.clamp_max(hits, k_max).to(torch.int32).contiguous()
    drops = torch.clamp_min(hits - k_max, 0).sum().to(torch.int32)
    return tile_idx, tile_cnt, drops


def _point_lighting_tiled(
    diffuse_color, roughness, n, p, v, ndotv,
    point_lights, tile_idx, tile_cnt, tile_h: int, tile_w: int,
):
    """Shade each pixel with its tile's culled light list: a loop over the
    K slots up to the largest count; slot k's light parameters are
    gathered per tile and broadcast over the tile's pixels, and slots at
    or past a tile's count are multiplied by 0.0 (the JAX package's
    arithmetic). Row counts that do not divide ``tile_h`` are padded to
    the tile grid and cropped after. Returns the point-light sum alone."""
    height, width = diffuse_color.shape[:2]
    n_ty, n_tx = tile_idx.shape[:2]
    k_max = tile_idx.shape[2]
    pad_rows = n_ty * tile_h - height
    if pad_rows:
        def padr(a):
            return torch.nn.functional.pad(
                a, (0, 0) * (a.ndim - 1) + (0, pad_rows))

        return _point_lighting_tiled(
            padr(diffuse_color), padr(roughness), padr(n), padr(p),
            padr(v), padr(ndotv), point_lights, tile_idx, tile_cnt,
            tile_h, tile_w)[:height]

    def t5(a, c):
        return a.reshape(n_ty, tile_h, n_tx, tile_w, c)

    dc5 = t5(diffuse_color, 3)
    r5 = t5(roughness, 1)[..., 0]
    n5 = t5(n, 3)
    p5 = t5(p, 3)
    v5 = t5(v, 3)
    nv5 = t5(ndotv, 1)[..., 0]

    def b(x):  # (Ty, Tx) or (Ty, Tx, 3) -> tile-broadcast shape
        if x.ndim == 2:
            return x[:, None, :, None]
        return x[:, None, :, None, :]

    acc = torch.zeros((n_ty, tile_h, n_tx, tile_w, 3), dtype=torch.float32,
                      device=diffuse_color.device)
    # No tile holds more than max(tile_cnt) lights: the slots past it are
    # all-masked work (one host read of the count).
    k_dyn = min(int(tile_cnt.max()), k_max) if tile_cnt.numel() else 0
    for k in range(k_dyn):
        lt = point_lights[tile_idx[:, :, k].long()]  # (Ty, Tx, 4, 4)
        on = (k < tile_cnt).to(torch.float32)[:, None, :, None]
        l_dir = pbr.normalize(b(lt[..., 0, :3]) - p5)
        h = pbr.normalize(v5 + l_dir)
        ldoth = pbr.saturate(torch.sum(l_dir * h, -1))
        ndoth = pbr.saturate(torch.sum(n5 * h, -1))
        ndotl = pbr.saturate(torch.sum(n5 * l_dir, -1))
        dif, spec = pbr.default_lit_bxdf(dc5, r5, ldoth, nv5, ndotl, ndoth)
        radiance = pbr.apply_point_light(
            b(lt[..., 0, :3]), b(lt[..., 1, :3]),
            b(lt[..., 1, 3]).broadcast_to(ndotl.shape),
            b(lt[..., 2, 3]).broadcast_to(ndotl.shape),
            p5, n5)
        acc = acc + radiance * (dif + spec[..., None]) * on[..., None]
    return acc.reshape(height, width, 3)


def _upsample2(a, axis: int, n_out: int):
    """2x bilinear upsample along ``axis`` for a signal sampled at even
    output pixels: out[2i] = a[i], out[2i+1] = (a[i] + a[i+1]) / 2
    (edge-clamped), cropped to ``n_out``."""
    n = a.shape[axis]
    nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                    dim=axis)
    mid = (a + nxt) * 0.5
    out = torch.stack([a, mid], dim=axis + 1)
    shape = list(a.shape)
    shape[axis] = 2 * n
    return out.reshape(shape).narrow(axis, 0, n_out)


def reflection_color(base_color, metallic, roughness, n, v, ndotv, ao,
                     cube_atlas, cubemap_size, sky_max_mips,
                     specular=0.5, env_fetch=None, ablate: str = "",
                     cube_pair1=None, half: bool = False,
                     cube_const=None):
    """Base.frag:104-112 / BaseLighting.frag:213-221: IBL reflection.

    Three tiers, by what the scene build attached: ``cube_const`` (minimum
    material roughness exactly 1.0: every tap reads one fixed 2x2 mip, a
    per-face bilinear over a (6, 2, 2, 3) table, selects and no gather),
    ``cube_pair1`` (minimum roughness >= 0.031: one row fetch of the
    half-resolution mip-pair cube at lod - 1) and the quad-packed cube
    atlas at the reflection lod.

    ``env_fetch(refl_dir, mips) -> (..., >= 3)`` replaces the cube tap
    (the merged environment table, ``ops/envtap.py``; it takes precedence
    over every tier). ``half`` runs the tap on the even pixels of a
    (H, W) frame and upsamples the radiance bilinearly (skipped with
    ``env_fetch``); the BRDF and occlusion stay at full resolution.
    ``ablate`` containing "reflgather" replaces the tap by a constant
    radiance (a diagnostic: the tap's cost apart from its math)."""
    spec = pbr.compute_f0(specular, base_color, metallic)
    brdf = pbr.env_brdf_approx(spec, roughness, ndotv)
    r = pbr.refract(v, pbr.normalize(n), 1.0 / 1.52)
    gather_ablated = "reflgather" in ablate
    const_tier = (cube_const is not None and env_fetch is None
                  and not gather_ablated)
    # The constant-lod tier reads no lod: the mips are not computed there.
    mips = None if const_tier else pbr.reflection_mip_from_roughness(
        roughness, torch.tensor(float(sky_max_mips), dtype=torch.float32,
                                device=r.device))
    h_full = w_full = None
    if half and r.ndim == 3 and env_fetch is None:
        h_full, w_full = r.shape[:2]
        r = r[::2, ::2]
        mips = None if mips is None else mips[::2, ::2]
    refl_v = pbr.specular_occlusion(ndotv, roughness * roughness, ao)
    if const_tier:
        refl_l = _const_lod_tap(cube_const, r)
    elif gather_ablated:
        refl_l = (torch.tensor([0.3, 0.4, 0.5], dtype=torch.float32,
                               device=r.device).broadcast_to(
                                   r.shape[:-1] + (3,))
                  + mips[..., None] * 1e-9 + r[..., :3] * 1e-9)
    elif env_fetch is not None:
        refl_l = env_fetch(r, mips)[..., :3] * 10.0
    else:
        zero_i = torch.zeros(mips.shape, dtype=torch.int32, device=r.device)
        if cube_pair1 is not None:
            # Exact whenever lod >= 1 (level k of the half-resolution chain
            # is cube level k + 1); the scene build attaches the table only
            # when its minimum roughness guarantees that.
            refl_l = sample_cubemap_lod(
                cube_pair1, zero_i, r, mips - 1.0, cubemap_size // 2,
                quad=False)[..., :3] * 10.0
        else:
            refl_l = sample_cubemap_lod(
                cube_atlas, zero_i, r, mips, cubemap_size,
                quad=cube_atlas.shape[-1] % 13 != 0)[..., :3] * 10.0
    if h_full is not None:
        refl_l = _upsample2(_upsample2(refl_l, 0, h_full), 1, w_full)
    return refl_l * refl_v[..., None] * brdf


def _const_lod_tap(cube_const, r):
    """The constant-lod tier: the bilinear tap of the fixed 2x2 mip of
    each face, with sample_cubemap_lod's and sample_trilinear_pair's
    uv, clamp and lerp arithmetic, as selects over the (6, 2, 2, 3)
    table. Returns the radiance (..., 3) (times 10, as every tier)."""
    face, uv = cube_direction_to_face_uv(r)
    uv = torch.clamp(uv, 0.25, 0.75)  # sample_cubemap_lod half-texel
    u = uv[..., 0] * 2.0 - 0.5
    vv = uv[..., 1] * 2.0 - 0.5
    x0 = torch.clamp(torch.floor(u), 0.0, 1.0)
    y0 = torch.clamp(torch.floor(vv), 0.0, 1.0)
    fu = torch.clamp(u - x0, 0.0, 1.0)[..., None]
    fv = torch.clamp(vv - y0, 0.0, 1.0)[..., None]
    x0b = (x0 >= 0.5)[..., None]
    y0b = (y0 >= 0.5)[..., None]
    true_b = torch.ones_like(x0b)

    def corner(dy, dx):
        # Edge-clamped corner (min(y0+dy,1), min(x0+dx,1)) selected from
        # the per-face 2x2 table - the same clamping the pair atlas bakes
        # into its neighbor groups.
        yi1 = true_b if dy else y0b
        xi1 = true_b if dx else x0b
        out = None
        for f in range(6):
            tab = cube_const[f]  # (2, 2, 3)
            v_ = torch.where(
                yi1,
                torch.where(xi1, tab[1, 1], tab[1, 0]),
                torch.where(xi1, tab[0, 1], tab[0, 0]),
            )
            out = v_ if out is None else torch.where(
                (face == f)[..., None], v_, out)
        return out

    t00 = corner(0, 0)
    t10 = corner(0, 1)
    t01 = corner(1, 0)
    t11 = corner(1, 1)
    lo_top = t00 * (1 - fu) + t10 * fu
    lo_bot = t01 * (1 - fu) + t11 * fu
    return (lo_top * (1 - fv) + lo_bot * fv) * 10.0


def shade_pixels(
    base_color, metallic, roughness, normal, ao, world_pos,
    shadow_factor, view, cube_atlas, cubemap_size, tiled_points=None,
    env_fetch=None, ablate: str = "", cube_pair1=None,
    refl_half: bool = False, cube_const=None, pallas_points=None,
):
    """Full lighting shared by forward and deferred paths.

    ``view`` is a ViewState (passes.view). Returns a dict of the lighting
    terms so callers can compose debug views (SPEC_CONSTANTS switch).

    The 4 push-constant material overrides (XkGlobalConstants
    BasecolorOverride/Metallic/Specular/Roughness, ZeldaEngine.cpp:903-919)
    apply here as multipliers, where the reference's Details panel intends
    them (the reference's shaders declare but never read them).
    """
    ov = getattr(view, "overrides", None)
    if ov is not None:
        base_color = base_color * ov[0]
        metallic = pbr.saturate(metallic * ov[1])
        roughness = torch.clamp(roughness * ov[3], 0.01, 1.0)
        specular = 0.5 * ov[2]
    else:
        specular = 0.5
    n = pbr.normalize(normal)
    v = pbr.normalize(view.camera_pos - world_pos)
    ndotv = pbr.saturate(torch.sum(n * v, -1))
    diffuse_color = base_color * (1.0 - metallic[..., None])

    counts = [int(c) for c in view.lights_count]
    if "nodirect" in ablate:  # diagnostic ablation
        direct = torch.zeros_like(base_color)
    else:
        direct = direct_lighting(
            diffuse_color, roughness, n, world_pos, v, ndotv, shadow_factor,
            view.dir_lights, counts[0],
            view.point_lights, counts[1],
            view.spot_lights, counts[2],
            tiled_points=tiled_points,
            pallas_points=pallas_points,
        )
    indirect = diffuse_color / math.pi * (ao * 0.3 * shadow_factor)[..., None]
    if "norefl" in ablate:  # diagnostic ablation
        refl = torch.zeros_like(base_color)
    else:
        refl = reflection_color(
            base_color, metallic, roughness, n, v, ndotv, ao,
            cube_atlas, cubemap_size, float(counts[3]),
            specular=specular, env_fetch=env_fetch, ablate=ablate,
            cube_pair1=cube_pair1, half=refl_half,
            cube_const=cube_const,
        )
    return {
        "direct": direct,
        "indirect": indirect,
        "reflection": refl,
        "final": direct + indirect + refl,
        "ndotv": ndotv,
    }
