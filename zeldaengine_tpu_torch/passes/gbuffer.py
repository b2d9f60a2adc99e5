"""Surface-attribute resolution and GBuffer packing.

The deferred GBuffer layout matches BaseScene.frag:43-47 / XkGBuffer
(ZeldaEngine.cpp:1294-1369):

  scene_color: (H, W, 4) Emissive.rgb, Mask.r
  gbuffer_a:   (H, W, 4) Normal * 0.5 + 0.5, 1
  gbuffer_b:   (H, W, 4) Metallic, 1.0 (Specular), Roughness, 1
  gbuffer_c:   (H, W, 4) BaseColor.rgb, AO
  gbuffer_d:   (H, W, 4) WorldPos.xyz, 1

The fused raster kernel already produced the interpolants and their
analytic screen-space derivatives (exact, replacing dFdx/dFdy quads); what
remains here is the material fetch (per-combo constants plus one mip-pair
atlas fetch of the spatially varying channels) and the TBN normal mapping.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.ops import pbr
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


def _finish_attributes(scene, config, covered, combo, uv, lod, vertex_color,
                       world_pos, frag_normal, duv_dx, duv_dy, dpos_dx,
                       dpos_dy, bary_min=None,
                       var_ch=None,
                       flat_normal: bool = False) -> SurfaceAttributes:
    """Material fetch + TBN on the interpolants of the fused kernel.
    Ablations (diagnostics, ``config.ablate``): "lodprobe" writes the
    tap's inputs (lod / 16, combo / 64, covered) into the base colour,
    "notex" replaces the fetch by constant texels."""
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
        normal = pbr.compute_tangent_normal(
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
