"""Shadow mapping: bias-matrix projection + PCF filtering.

Ports Common.glsl:294-342 (BiasMat, ComputeShadowCoord, ShadowDepthProject,
ComputePCF). ``compute_pcf`` is the plain 25-gather filter: the exact
reference every PCF backend is held against, and the version that runs for
CPU tensors. The kernel that serves the frame on the card lives in
``ops/pcf_cuda.py``.
"""

from __future__ import annotations

import torch

SHADOW_IN_FACTOR = 0.1  # ShadowDepthProject: factor when occluded (:315)


def compute_shadow_coord(shadowmap_space: torch.Tensor,
                         position: torch.Tensor):
    """BiasMat * ShadowmapSpace * (P, 1) (Common.glsl:294-304).

    BiasMat maps ndc xy [-1,1] -> uv [0,1] (z untouched).
    Returns (..., 4) homogeneous shadow coords.
    """
    p = position
    clip = (
        p[..., 0, None] * shadowmap_space[..., :, 0]
        + p[..., 1, None] * shadowmap_space[..., :, 1]
        + p[..., 2, None] * shadowmap_space[..., :, 2]
        + shadowmap_space[..., :, 3]
    )
    x = clip[..., 0] * 0.5 + clip[..., 3] * 0.5
    y = clip[..., 1] * 0.5 + clip[..., 3] * 0.5
    return torch.stack([x, y, clip[..., 2], clip[..., 3]], -1)


def _shadow_tap(shadowmap: torch.Tensor, sc, offset_u, offset_v, bias=0.0):
    """ShadowDepthProject (Common.glsl:307-319): nearest-texel compare.

    sc: (..., 4) shadow coord ALREADY divided by w (as the callers do:
    ``ComputePCF(sp, ShadowCoord / ShadowCoord.w, 2)``).
    Returns shadow factor 1.0 (lit) or 0.1 (occluded).
    """
    dim_y, dim_x = shadowmap.shape[-2], shadowmap.shape[-1]
    u = sc[..., 0] + offset_u
    v = sc[..., 1] + offset_v
    # texture() on the shadow sampler: repeat addressing, nearest texel.
    ix = torch.remainder(torch.floor(u * dim_x).to(torch.int32), dim_x)
    iy = torch.remainder(torch.floor(v * dim_y).to(torch.int32), dim_y)
    dist = shadowmap.reshape(-1)[(iy * dim_x + ix).long()]
    z = sc[..., 2]
    w = sc[..., 3]
    occluded = (z > -1.0) & (z < 1.0) & (w > 0.0) & (dist < z - bias)
    one = torch.ones_like(z)
    return torch.where(occluded, one * SHADOW_IN_FACTOR, one)


def compute_pcf(shadowmap: torch.Tensor, shadow_coord: torch.Tensor,
                radius: int = 2, scale: float = 1.5, bias: float = 0.0):
    """ComputePCF (Common.glsl:323-342): (2r+1)^2 taps at ``scale`` texel
    spacing, averaged. ``shadow_coord`` is the homogeneous coord (divided by
    w here, matching the call sites Base.frag:67 / BaseLighting.frag:178).

    The f32 sum is taken in oy-major / ox-minor tap order; the order is
    part of the result (25 x 0.1 in f32 is not 2.5)."""
    w = shadow_coord[..., 3, None]
    sc = shadow_coord / torch.where(torch.abs(w) > 1e-20, w,
                                    torch.ones_like(w))
    dim_y, dim_x = shadowmap.shape[-2], shadowmap.shape[-1]
    flat = shadowmap.reshape(-1)
    z = sc[..., 2]
    w_post = sc[..., 3]
    in_range = (z > -1.0) & (z < 1.0) & (w_post > 0.0)
    z_cmp = z - bias
    fx = sc[..., 0] * dim_x
    fy = sc[..., 1] * dim_y
    one = torch.ones_like(z)
    shadowed = one * SHADOW_IN_FACTOR
    total = torch.zeros_like(z)
    count = 0
    for oy in range(-radius, radius + 1):
        iy = torch.remainder(
            torch.floor(fy + scale * oy).to(torch.int32), dim_y)
        base = iy * dim_x
        for ox in range(-radius, radius + 1):
            ix = torch.remainder(
                torch.floor(fx + scale * ox).to(torch.int32), dim_x)
            dist = flat[(base + ix).long()]
            occluded = in_range & (dist < z_cmp)
            total = total + torch.where(occluded, shadowed, one)
            count += 1
    return total / count
