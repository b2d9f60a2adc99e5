"""Surface-attribute resolution and GBuffer packing.

The deferred GBuffer layout matches BaseScene.frag:43-47 / XkGBuffer
(ZeldaEngine.cpp:1294-1369):

  scene_color: (H, W, 4) Emissive.rgb, Mask.r
  gbuffer_a:   (H, W, 4) Normal * 0.5 + 0.5, 1
  gbuffer_b:   (H, W, 4) Metallic, 1.0 (Specular), Roughness, 1
  gbuffer_c:   (H, W, 4) BaseColor.rgb, AO
  gbuffer_d:   (H, W, 4) WorldPos.xyz, 1

Two paths produce the interpolants and their analytic screen-space
derivatives (exact, replacing dFdx/dFdy quads): the fused raster kernel
writes them as planes (``surface_attributes_from_planes``), or the gather
path computes them from a visibility buffer (``surface_attributes``: one
gather of the winner's record per pixel). What both share is the material
fetch (per-combo constants plus one mip-pair atlas fetch of the spatially
varying channels) and the TBN normal mapping.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.math import transforms
from zeldaengine_tpu_torch.ops import pbr
from zeldaengine_tpu_torch.ops.rasterize import TriangleSetup, _pixel_grid
from zeldaengine_tpu_torch.ops.texture import sample_trilinear_packed


class SurfaceAttributes(NamedTuple):
    covered: torch.Tensor  # (H, W) bool
    world_pos: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor  # (H, W, 3) mapped shading normal (TBN + normal map)
    vertex_color: torch.Tensor  # (H, W, 3)
    base_color: torch.Tensor  # (H, W, 3)
    metallic: torch.Tensor  # (H, W)
    roughness: torch.Tensor  # (H, W) (max 0.01 applied)
    ao: torch.Tensor  # (H, W)
    emissive: torch.Tensor  # (H, W, 3)
    mask: torch.Tensor  # (H, W)
    # Minimum barycentric weight of the covering triangle (0 at edges):
    # drives the wireframe debug mode (ENABLE_WIREFRAME / polygonMode
    # LINE, ZeldaEngine.cpp:90, :5108-5110). None when not computed.
    bary_min: Optional[torch.Tensor] = None


def _material_texels(scene, config, combo, uv, lod, var_ch):
    """The per-pixel material fetch: ONE mip-pair row fetch over the
    VARYING channels + per-combo constants for the rest (constant-slot
    elision: default PBR slots are spatially constant). Returns (H, W, 13)
    in the canonical channel order [bc.rgb, nrm.rgb, em.rgb, metallic,
    roughness, ao, mask].

    ``var_ch`` = SceneMeta.tex_channels (None = legacy full-16 atlas)."""
    if scene.mat_const is None:
        return sample_trilinear_packed(
            scene.combined_atlas, combo, uv, lod, config.texture_size)
    assert var_ch is not None, (
        "scene was built with constant-slot elision; pass "
        "var_ch=SceneMeta.tex_channels")
    n_var = scene.combined_atlas.shape[-1] // 13
    assert n_var == max(len(var_ch), 1), (n_var, var_ch)
    tex_var = None
    if var_ch:
        tex_var = sample_trilinear_packed(
            scene.combined_atlas, combo, uv, lod, config.texture_size)
    var_set = set(var_ch)
    const_ch = [c for c in range(13) if c not in var_set]
    mc = scene.mat_const.shape[0]
    if const_ch:
        table = scene.mat_const[:, const_ch]  # (Mc, k2)
        shape = combo.shape + table.shape[1:]
        if mc <= 8:
            # Select chain beats a per-pixel gather at few combos.
            cvals = table[0].broadcast_to(shape)
            for i in range(1, mc):
                cvals = torch.where((combo == i)[..., None], table[i], cvals)
        else:
            cvals = table[combo.long()]
        if not var_ch:
            return cvals  # all 13 channels, in canonical order
    chans = []
    vi = ci = 0
    for c in range(13):
        if c in var_set:
            chans.append(tex_var[..., vi])
            vi += 1
        else:
            chans.append(cvals[..., ci])
            ci += 1
    return torch.stack(chans, dim=-1)


def _gathered_tangent_normal(dpos_dx, dpos_dy, uv_dx, uv_dy, frag_normal,
                             tex_normal):
    """``pbr.compute_tangent_normal`` in the form XLA's CPU code gives it
    inside the JAX package's jitted gather path (``surface_attributes``,
    the same machine code in its frame at ``raster="pallas"``): each
    difference of two products fuses its first product, each dot product
    and sum of squares is an fma chain from component 0 (square roots
    correctly rounded), and the vectorised loops split the components:
    ``t - n (n . t)`` is fused on components 0 and 1 only, and the first
    sum of ``t v0 + b v1 + n v2`` fuses ``b v1`` on components 0 and 1 and
    ``t v0`` on component 2, the last sum unfused. The planes route keeps
    ``pbr.compute_tangent_normal`` (its compiled form there)."""
    fma = transforms.fma_f32

    def normalize(v):
        return v / transforms.sqrt_f32(
            torch.clamp_min(transforms.dot3(v, v), 1e-20))[..., None]

    def cross(a, b):  # a_j b_k - a_k b_j, the first product fused
        return fma(a.roll(-1, -1), b.roll(1, -1),
                   -(a.roll(1, -1) * b.roll(-1, -1)))

    denom = fma(uv_dx[..., 0], uv_dy[..., 1], -(uv_dy[..., 0] * uv_dx[..., 1]))
    denom = torch.where(torch.abs(denom) > 1e-12, denom,
                        torch.full_like(denom, 1e-12))
    t = fma(uv_dy[..., 1, None], dpos_dx,
            -(uv_dx[..., 1, None] * dpos_dy)) / denom[..., None]
    n = normalize(frag_normal)
    nt = transforms.dot3(n, t)[..., None]
    t = normalize(torch.cat([fma(-n[..., :2], nt, t[..., :2]),
                             t[..., 2:] - n[..., 2:] * nt], -1))
    b = normalize(cross(n, t))
    v = normalize(2.0 * normalize(tex_normal) - 1.0)
    tv = t * v[..., 0:1]
    bv = b * v[..., 1:2]
    first = torch.cat([fma(b[..., :2], v[..., 1:2], tv[..., :2]),
                       fma(t[..., 2:], v[..., 0:1], bv[..., 2:])], -1)
    return normalize(first + n * v[..., 2:3])


def _finish_attributes(scene, config, covered, combo, uv, lod, vertex_color,
                       world_pos, frag_normal, duv_dx, duv_dy, dpos_dx,
                       dpos_dy, bary_min=None,
                       var_ch=None,
                       flat_normal: bool = False,
                       tangent_normal=pbr.compute_tangent_normal,
                       ) -> SurfaceAttributes:
    """Material fetch + TBN (``tangent_normal``) on the interpolants of
    either path. Ablations (diagnostics, ``config.ablate``): "lodprobe"
    writes the tap's inputs (lod / 16, combo / 64, covered) into the base
    colour, "notex" replaces the fetch by constant texels."""
    if "lodprobe" in config.ablate:
        texels = torch.zeros(uv.shape[:2] + (16,), dtype=torch.float32,
                             device=uv.device)
        texels[..., 0] = lod / 16.0
        texels[..., 1] = combo.to(torch.float32) / 64.0
        texels[..., 2] = covered.to(torch.float32)
        texels[..., 10] = 1.0
    elif "notex" in config.ablate:
        texels = torch.tensor(
            [0.5] * 3 + [0.5, 0.5, 1.0] + [0.0] * 3
            + [0.0, 0.8, 1.0, 1.0] + [0.0] * 3, dtype=torch.float32,
            device=uv.device).broadcast_to(uv.shape[:2] + (16,)) \
            + lod[..., None] * 1e-9
    else:
        texels = _material_texels(scene, config, combo, uv, lod, var_ch)
    base_color = texels[..., 0:3]
    tex_normal = texels[..., 3:6]
    emissive = texels[..., 6:9]
    metallic = pbr.saturate(texels[..., 9])
    roughness = torch.clamp_min(pbr.saturate(texels[..., 10]), 0.01)
    ao = texels[..., 11]
    mask = texels[..., 12]

    if flat_normal:
        # Never taken today (SceneMeta keeps flat_normal False): the
        # reference's TBN normalizes the map value BEFORE the 2x-1 remap
        # (Common.glsl:126 quirk), so even the flat default normal
        # (0.5, 0.5, 1) TILTS the shading normal along the uv-derived
        # tangent frame. Kept for a scene whose constant map value is
        # exactly tangent-space +Z after that quirk.
        normal = pbr.normalize(frag_normal)
    else:
        normal = tangent_normal(
            dpos_dx, dpos_dy, duv_dx, duv_dy, frag_normal, tex_normal
        )

    return SurfaceAttributes(
        covered=covered,
        world_pos=world_pos,
        normal=normal,
        vertex_color=vertex_color,
        base_color=base_color,
        metallic=metallic,
        roughness=roughness,
        ao=ao,
        emissive=emissive,
        mask=mask,
        bary_min=bary_min,
    )


def surface_attributes(
    scene,
    setup: TriangleSetup,
    tri_id: torch.Tensor,
    pair_world: torch.Tensor,
    pair_normal_world: torch.Tensor,
    config: EngineConfig,
    y0: int = 0,
    var_ch=None,
    flat_normal: bool = False,
) -> SurfaceAttributes:
    """Resolve per-pixel surface attributes from a visibility buffer
    ``tri_id`` (H, W) of rows of ``setup`` (-1 uncovered), the rows those
    of the band from viewport row ``y0``: the gather path of the raster
    routes without attribute planes (``raster`` "pallas" and "jnp").

    One gather per pixel of the winner's 43-float record: its edge
    coefficients (9), its material id as a float VALUE (rounded back; a
    bit cast would make ids 1-63 subnormal) and its three corners'
    interpolants (uv 2, colour 3, world position 3, world normal 3). The
    multiply-adds are fused where the JAX package's compiled gather path
    fuses them on the CPU (``transforms.fma_f32``, looked up at each call:
    a caller may patch it to note the calls): the edge values, the quotient
    rule, the three-corner mix, the uv footprint and the TBN
    (``_gathered_tangent_normal``). Plain PyTorch (and kernel ``fma``) on
    every device: the JAX package computes this outside any Pallas
    kernel."""
    fma_f32 = transforms.fma_f32
    height, width = tri_id.shape
    covered = tri_id >= 0
    tid = torch.clamp_min(tri_id, 0).long()
    n_t = setup.edge.shape[0]
    pair_all = torch.cat([scene.pair_static[:, :5], pair_world,
                          pair_normal_world], dim=1)  # (P, 11)
    corners = pair_all[scene.tri_vtx[:n_t].long()]  # (T, 3, 11)
    rec = torch.cat([setup.edge.reshape(n_t, 9),
                     scene.tri_meta[:n_t, 3:4].to(torch.float32),
                     corners.reshape(n_t, 33)], dim=1)  # (T, 43)
    r = rec[tid]  # (H, W, 43)
    del rec, corners
    edge = r[..., :9].reshape(height, width, 3, 3)
    mat_id = torch.round(r[..., 9]).to(torch.int32)
    corner_px = r[..., 10:43].reshape(height, width, 3, 11)

    px, py = _pixel_grid(height, width, y0=y0, device=tri_id.device)
    ax = edge[..., 0]
    ay = edge[..., 1]
    u = fma_f32(ax, px[..., None], ay * py[..., None]) + edge[..., 2]
    esum = u[..., 0] + u[..., 1] + u[..., 2]
    inv = 1.0 / torch.where(torch.abs(esum) > 1e-20, esum,
                            torch.ones_like(esum))
    # Uncovered pixels would interpolate record 0 far outside its
    # triangle: their weights are exact zeros (pack_gbuffer relies on it).
    inv = torch.where(covered, inv, torch.zeros_like(inv))[..., None]
    bary = u * inv  # (H, W, 3)
    del u, esum
    # d(bary)/dx = (A_x - bary * sum(A_x)) / esum (quotient rule).
    sax = ax[..., 0:1] + ax[..., 1:2] + ax[..., 2:3]
    say = ay[..., 0:1] + ay[..., 1:2] + ay[..., 2:3]
    dbary_dx = fma_f32(-bary, sax, ax) * inv
    dbary_dy = fma_f32(-bary, say, ay) * inv

    def mix(weights):  # sum over the corners, an fma chain from corner 0
        w = weights[..., None]
        return fma_f32(w[..., 2, :], corner_px[..., 2, :], fma_f32(
            w[..., 1, :], corner_px[..., 1, :],
            w[..., 0, :] * corner_px[..., 0, :]))

    a_i = mix(bary)
    a_dx = mix(dbary_dx)
    a_dy = mix(dbary_dy)
    # The per-pixel record (~360 MB at 1080p) is no longer needed.
    del r, edge, ax, ay, corner_px, dbary_dx, dbary_dy
    duv_dx = a_dx[..., 0:2]
    duv_dy = a_dy[..., 0:2]

    # Texture lod from the analytic uv footprint (texture() semantics).
    ts = float(config.texture_size)
    foot = torch.maximum(
        fma_f32(duv_dx[..., 1], duv_dx[..., 1],
                duv_dx[..., 0] * duv_dx[..., 0]),
        fma_f32(duv_dy[..., 1], duv_dy[..., 1],
                duv_dy[..., 0] * duv_dy[..., 0]))
    lod = torch.clamp_min(
        0.5 * torch.log2(torch.clamp_min(foot * ts * ts, 1e-12)), 0.0)

    combo = scene.mat_combined[mat_id.long()]
    bary_min = torch.where(covered, torch.amin(bary, dim=-1),
                           torch.zeros_like(bary[..., 0]))
    return _finish_attributes(
        scene, config, covered, combo, uv=a_i[..., 0:2], lod=lod,
        vertex_color=a_i[..., 2:5], world_pos=a_i[..., 5:8],
        frag_normal=a_i[..., 8:11], duv_dx=duv_dx, duv_dy=duv_dy,
        dpos_dx=a_dx[..., 5:8], dpos_dy=a_dy[..., 5:8], bary_min=bary_min,
        var_ch=var_ch, flat_normal=flat_normal,
        tangent_normal=_gathered_tangent_normal)


def surface_attributes_from_planes(
    scene, planes: torch.Tensor, config: EngineConfig, var_ch=None,
    flat_normal: bool = False,
) -> SurfaceAttributes:
    """Build SurfaceAttributes from the fused kernel's (ATTR_CH, H, W)
    output planes (ops/rasterize_cuda.py ATTR_CH layout): the kernel
    already did the record fetch, interpolation and analytic derivatives;
    only the material fetch + TBN remain here. The ablation "noattrs" (a
    diagnostic) returns constant attributes that read only plane 0."""
    if "noattrs" in config.ablate:
        z1 = planes[0] * 1e-9
        v3 = torch.stack([z1, z1, z1 + 1.0], -1)
        return SurfaceAttributes(
            covered=planes[0] > 0.5, world_pos=v3, normal=v3,
            vertex_color=v3, base_color=v3 * 0.5, metallic=z1,
            roughness=z1 + 0.5, ao=z1 + 1.0, emissive=v3 * 0.0,
            mask=z1 + 1.0, bary_min=z1,
        )

    def v(lo, hi):  # channel-major -> (H, W, C)
        return torch.movedim(planes[lo:hi], 0, -1)

    covered = planes[0] > 0.5
    # Plane 0 packs covered (+1.0) with the min barycentric weight.
    bary_min = torch.clamp_min(planes[0] - 1.0, 0.0)
    # Combo rides as a float VALUE; round back to the layer index.
    combo = torch.round(planes[1]).to(torch.int32)
    return _finish_attributes(
        scene, config, covered, combo,
        uv=v(2, 4), lod=planes[4], vertex_color=v(5, 8),
        world_pos=v(8, 11), frag_normal=v(11, 14),
        duv_dx=v(14, 16), duv_dy=v(16, 18),
        dpos_dx=v(18, 21), dpos_dy=v(21, 24), bary_min=bary_min,
        var_ch=var_ch, flat_normal=flat_normal,
    )


class GBuffer(NamedTuple):
    scene_color: torch.Tensor
    gbuffer_a: torch.Tensor
    gbuffer_b: torch.Tensor
    gbuffer_c: torch.Tensor
    gbuffer_d: torch.Tensor
    depth: torch.Tensor


def pack_gbuffer(attrs: SurfaceAttributes, depth: torch.Tensor) -> GBuffer:
    """BaseScene.frag:43-47; uncovered pixels = clear values (zeros)."""
    m = attrs.covered[..., None]
    n_packed = (pbr.normalize(attrs.normal) + 1.0) * 0.5
    # Quantize like the A2R10G10B10 / RGBA8 attachments the reference uses
    # (torch.round, like the JAX package's, rounds half to even).
    n_packed = torch.round(n_packed * 1023.0) / 1023.0

    def q8(x):
        return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0

    def masked(x):
        return torch.where(m, x, torch.zeros_like(x))

    ones = torch.ones_like(attrs.metallic)
    scene_color = masked(
        torch.cat([q8(attrs.emissive), q8(attrs.mask)[..., None]], -1))
    ga = masked(torch.cat([n_packed, ones[..., None]], -1))
    gb = masked(torch.stack(
        [q8(attrs.metallic), ones, q8(attrs.roughness), ones], -1))
    gc = masked(
        torch.cat([q8(attrs.base_color), q8(attrs.ao)[..., None]], -1))
    gd = masked(torch.cat([attrs.world_pos, ones[..., None]], -1))
    return GBuffer(
        scene_color=scene_color,
        gbuffer_a=ga,
        gbuffer_b=gb,
        gbuffer_c=gc,
        gbuffer_d=gd,
        depth=depth,
    )
