"""The shared lighting core of Base.frag:73-117 / BaseLighting.frag:180-235.

Direct (Disney diffuse + GGX specular per light), indirect (Lambert * AO *
0.3 * shadow), and IBL reflection (refract-vector cubemap lookup, Lazarov
env BRDF, x10 intensity). Vectorized over pixel grids; the per-light loops
are plain Python loops over the light tables.
"""

from __future__ import annotations

import math

import torch

from zeldaengine_tpu_torch.ops import pbr
from zeldaengine_tpu_torch.ops.texture import cube_direction_to_face_uv


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
    tiled_points=None,
    pallas_points=None,
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
    """
    if tiled_points is not None or pallas_points is not None:
        raise NotImplementedError(
            "culled point-light lists (the tiled loop and the point-light "
            "kernel) are not ported yet (ROADMAP.md B: K5 "
            "ops/lighting_pallas.py::_point_kernel)")

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
    for i in live(point_lights, n_point):
        acc = acc + bxdf_times_radiance(point_lights[i], "point")
    if spot_lights is not None:
        for i in live(spot_lights, n_spot):
            acc = acc + bxdf_times_radiance(spot_lights[i], "spot")
    return acc


def reflection_color(base_color, metallic, roughness, n, v, ndotv, ao,
                     cube_atlas, cubemap_size, sky_max_mips,
                     specular=0.5, env_fetch=None, ablate: str = "",
                     cube_pair1=None, half: bool = False,
                     cube_const=None):
    """Base.frag:104-112 / BaseLighting.frag:213-221: IBL reflection.

    Only the constant-lod tier is ported: a scene whose minimum material
    roughness is exactly 1.0 carries ``cube_const`` (6, 2, 2, 3), and every
    reflection tap is a per-face bilinear over that table (selects, no
    gather) - the exact uv/clamp/lerp math of the variable-lod sampler at
    its one fixed mip. The variable-lod taps (``cube_pair1``, the quad
    atlas, ``env_fetch``) and ``half`` raise.
    """
    if env_fetch is not None or half or ablate:
        raise NotImplementedError(
            "reflection options env_fetch / half / ablate are not ported "
            "yet (ROADMAP.md A4: ops/lighting.py::reflection_color)")
    if cube_const is None:
        raise NotImplementedError(
            "variable-lod cubemap reflection (cube_pair1 / quad atlas "
            "samplers) is not ported yet (ROADMAP.md A4: ops/texture.py "
            "samplers)")
    spec = pbr.compute_f0(specular, base_color, metallic)
    brdf = pbr.env_brdf_approx(spec, roughness, ndotv)
    r = pbr.refract(v, pbr.normalize(n), 1.0 / 1.52)

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
    refl_l = (lo_top * (1 - fv) + lo_bot * fv) * 10.0
    refl_v = pbr.specular_occlusion(ndotv, roughness * roughness, ao)
    return refl_l * refl_v[..., None] * brdf


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
    direct = direct_lighting(
        diffuse_color, roughness, n, world_pos, v, ndotv, shadow_factor,
        view.dir_lights, counts[0],
        view.point_lights, counts[1],
        view.spot_lights, counts[2],
        tiled_points=tiled_points,
        pallas_points=pallas_points,
    )
    indirect = diffuse_color / math.pi * (ao * 0.3 * shadow_factor)[..., None]
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
