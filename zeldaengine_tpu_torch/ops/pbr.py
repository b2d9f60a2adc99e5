"""PBR shading math - vectorized port of Shaders/Common.glsl.

Every function is elementwise over arbitrary leading pixel dims. Parity
sources are noted per function (Common.glsl file:line).
"""

from __future__ import annotations

import torch

PI = 3.14159265359
F0_DIELECTRIC = 0.04  # Common.glsl:91 `vec3 F0 = vec3(0.04)`


def saturate(x):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, 0.0, 1.0)
    return min(max(float(x), 0.0), 1.0)


def pow5(x):
    """x**5 by repeated squaring, ((x*x)*(x*x))*x - written out so every
    path computes the identical float sequence."""
    x2 = x * x
    return x2 * x2 * x


def f_schlick(f0, f90, u):
    """Common.glsl:134-137 - Fresnel Schlick. f0 may be (..., 3)."""
    return f0 + (f90 - f0) * pow5(1.0 - u)


def f_schlick_roughness(f0, cos_theta, roughness):
    """Common.glsl:141-144 - roughness-aware Fresnel for IBL."""
    return f0 + (torch.maximum(1.0 - roughness, f0) - f0) * pow5(
        1.0 - cos_theta
    )


def fr_disney_diffuse(ndotv, ndotl, ldoth, roughness):
    """Common.glsl:148-157 - Disney diffuse term (scalar)."""
    e_bias = 0.5 * roughness
    e_factor = (1.0 - roughness) + (1.0 / 1.51) * roughness
    fd90 = e_bias + 2.0 * ldoth * ldoth * roughness
    light_scatter = f_schlick(torch.ones_like(fd90), fd90, ndotl)
    view_scatter = f_schlick(torch.ones_like(fd90), fd90, ndotv)
    return light_scatter * view_scatter * e_factor


def v_smith_ggx_correlated(ndotv, ndotl, roughness):
    """Common.glsl:161-174 - height-correlated Smith visibility."""
    a2 = roughness * roughness
    ggxv = ndotl * torch.sqrt(ndotv * ndotv * (1.0 - a2) + a2)
    ggxl = ndotv * torch.sqrt(ndotl * ndotl * (1.0 - a2) + a2)
    ggx = ggxv + ggxl
    pos = ggx > 0.0
    return torch.where(
        pos, 0.5 / torch.where(pos, ggx, torch.ones_like(ggx)),
        torch.zeros_like(ggx))


def d_ggx(ndoth, roughness):
    """Common.glsl:178-183 - GGX NDF (with the reference's alpha=roughness^1
    convention: alphaRoughnessSq = roughness * roughness)."""
    a2 = roughness * roughness
    f = (ndoth * a2 - ndoth) * ndoth + 1.0
    return a2 / (PI * f * f)


REFLECTION_CAPTURE_ROUGHEST_MIP = 1.0
REFLECTION_CAPTURE_ROUGHNESS_MIP_SCALE = 1.2


def reflection_mip_from_roughness(roughness, cubemap_max_mip):
    """Common.glsl:191-198 - roughness -> absolute cubemap mip."""
    level_from_1x1 = (
        REFLECTION_CAPTURE_ROUGHEST_MIP
        - REFLECTION_CAPTURE_ROUGHNESS_MIP_SCALE
        * torch.log2(torch.clamp_min(roughness, 0.001))
    )
    return cubemap_max_mip - 1.0 - level_from_1x1


def env_brdf_approx_lazarov(roughness, nov):
    """Common.glsl:201-211 - Lazarov analytic env BRDF. Returns (A, B)."""
    c0 = torch.tensor([-1.0, -0.0275, -0.572, 0.022], dtype=torch.float32,
                      device=roughness.device)
    c1 = torch.tensor([1.0, 0.0425, 1.04, -0.04], dtype=torch.float32,
                      device=roughness.device)
    r = roughness[..., None] * c0 + c1
    a004 = (
        torch.minimum(r[..., 0] * r[..., 0], torch.exp2(-9.28 * nov))
        * r[..., 0]
        + r[..., 1]
    )
    a = -1.04 * a004 + r[..., 2]
    b = 1.04 * a004 + r[..., 3]
    return a, b


def env_brdf_approx(specular_color, roughness, nov):
    """Common.glsl:214-223."""
    a, b = env_brdf_approx_lazarov(roughness, nov)
    f90 = saturate(50.0 * specular_color[..., 1])
    return specular_color * a[..., None] + (f90 * b)[..., None]


def specular_occlusion(nov, roughness_sq, ao):
    """Common.glsl:226-229."""
    return saturate(torch.pow(nov + ao, roughness_sq) - 1.0 + ao)


def dielectric_specular_to_f0(specular):
    """Common.glsl:232-235."""
    return F0_DIELECTRIC * 2.0 * specular


def compute_f0(specular, base_color, metallic):
    """Common.glsl:238-243 - clamps pure black basecolor to F0."""
    base = torch.clamp(base_color, F0_DIELECTRIC, 1.0)
    diel = dielectric_specular_to_f0(specular)
    diel = torch.as_tensor(diel, dtype=torch.float32,
                           device=base.device).broadcast_to(
        base.shape[:-1])[..., None]
    return diel + (base - diel) * metallic[..., None]


def diffuse_lambert(diffuse_color):
    """Common.glsl:253-256."""
    return diffuse_color * (1.0 / PI)


def default_lit_bxdf(diffuse_color, roughness, ldoth, ndotv, ndotl, ndoth):
    """Common.glsl:259-282 DefaultLitBxDF.

    Returns (diffuse (...,3), specular (...,)) - matches the reference's use
    of the global dielectric F0=0.04 (NOT the passed SpecularColor) for the
    Fresnel term, and scalar Fr broadcast over RGB.
    """
    f0 = torch.tensor(F0_DIELECTRIC, dtype=torch.float32,
                      device=ldoth.device)
    f90 = torch.clamp(
        torch.tensor(50.0 * F0_DIELECTRIC, dtype=torch.float32,
                     device=ldoth.device), 0.0, 1.0)
    f = f_schlick(f0, f90, ldoth)  # (...,) scalar
    vis = v_smith_ggx_correlated(ndotv, ndotl, roughness)
    d = d_ggx(ndoth, roughness)
    fr = f * d * vis
    fd = fr_disney_diffuse(ndotv, ndotl, ldoth, roughness)
    diffuse = diffuse_color * ((1.0 - f) * fd)[..., None]
    return diffuse, fr


def refract(incident, normal, eta):
    """GLSL refract(I, N, eta) - used for the IBL lookup vector
    (Base.frag:106-108 with I = V, ratio = 1.0/1.52)."""
    cosi = torch.sum(normal * incident, dim=-1, keepdim=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta * incident - (
        eta * cosi + torch.sqrt(torch.clamp_min(k, 0.0))) * normal
    return torch.where(k < 0.0, torch.zeros_like(refr), refr)


def normalize(v, eps=1e-20):
    return v / torch.sqrt(
        torch.clamp_min(torch.sum(v * v, dim=-1, keepdim=True), eps))


# --------------------------------------------------------------- light helpers


def apply_directional_light(light_dir, light_color, light_intensity, normal):
    """Common.glsl:364-372 - NdotL * intensity * color.

    ``light_dir`` is the raw direction.xyz from the light table (the GLSL
    normalizes it); points *toward* the light.
    """
    l = normalize(light_dir)
    n = normalize(normal)
    ndotl = saturate(torch.sum(n * l, dim=-1))
    return ndotl[..., None] * light_intensity[..., None] * light_color


def apply_point_light(light_pos, light_color, light_intensity, light_radius,
                      position, normal):
    """Common.glsl:399-416 - linear falloff: att = 1 - clamp(d/falloff)."""
    to_light = light_pos - position
    l = normalize(to_light)
    n = normalize(normal)
    ndotl = saturate(torch.sum(n * l, dim=-1))
    dist = torch.sqrt(
        torch.clamp_min(torch.sum(to_light * to_light, dim=-1), 1e-20))
    # remap(dist, 0, falloff, 0, 1) == clamp(dist,0,falloff)/falloff
    safe_r = torch.clamp_min(light_radius, 1e-6)
    attenuation = 1.0 - torch.clamp(dist / safe_r, 0.0, 1.0)
    return (ndotl * light_intensity * attenuation)[..., None] * light_color


def spot_cone_factor(light_pos, spot_dir, cos_inner, cos_outer, position):
    """Spot-light cone attenuation (smoothstep between outer and inner
    cone cosines). The reference declares spotLights[16] (Base.frag:15,
    XkView ZeldaEngine.cpp:922-965) but never shades them; this implements
    the conventional semantics its data layout implies. ExtraData.xy holds
    (cosInner, cosOuter); zeros fall back to 25deg/30deg."""
    cos_outer = torch.where(cos_outer > 0.0, cos_outer,
                            torch.full_like(cos_outer, 0.8660254))  # cos 30
    cos_inner = torch.maximum(
        torch.where(cos_inner > 0.0, cos_inner,
                    torch.full_like(cos_inner, 0.90630779)),  # cos 25
        cos_outer + 1e-4,
    )
    to_pix = normalize(position - light_pos)
    cd = torch.sum(
        to_pix * normalize(spot_dir.broadcast_to(position.shape)), dim=-1)
    t = saturate((cd - cos_outer) / (cos_inner - cos_outer))
    return t * t * (3.0 - 2.0 * t)  # smoothstep


def compute_tangent_normal(world_pos_dx, world_pos_dy, uv_dx, uv_dy,
                           frag_normal, tex_normal):
    """Common.glsl:113-127 ComputeNormal - screen-space-derivative TBN.

    The dFdx/dFdy inputs come from the rasterizer's per-pixel analytic
    derivatives.
    """
    denom = uv_dx[..., 0] * uv_dy[..., 1] - uv_dy[..., 0] * uv_dx[..., 1]
    denom = torch.where(torch.abs(denom) > 1e-12, denom,
                        torch.full_like(denom, 1e-12))
    t = (uv_dy[..., 1, None] * world_pos_dx
         - uv_dx[..., 1, None] * world_pos_dy) / denom[..., None]
    n = normalize(frag_normal)
    t = normalize(t - n * torch.sum(n * t, dim=-1, keepdim=True))
    b = normalize(torch.linalg.cross(n, t, dim=-1))
    tn = normalize(tex_normal)
    # TBN * normalize(2*n_tex - 1): note the reference uses 2.0*n - 1.0 on an
    # already-normalized vector (Common.glsl:126).
    v = normalize(2.0 * tn - 1.0)
    world_n = (
        t * v[..., 0, None] + b * v[..., 1, None] + n * v[..., 2, None]
    )
    return normalize(world_n)
