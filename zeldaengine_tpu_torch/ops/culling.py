"""GPU-driven meshlet culling: frustum + backface-cone tests.

Implements what the reference bakes but never executes (XkMeshlet carries
bounds/cone data, ZeldaEngine.cpp:689-702). Plain tensor math over the
meshlet records on the frame's device, no kernel: one frame culls 14 k
records at bench config 4.

The masks are boolean tests of rounded sums, so a record whose plane
distance lies within rounding of ``-radius`` flips with the last bit. The
sums are therefore formed as the JAX package's compiled cull forms them on
the CPU: each dot product and sum of squares is the chain
``fma(x2, y2, fma(x1, y1, x0 * y0))`` (``math/transforms.py::dot3``, its
fused multiply-adds through ``fma_f32``), square roots are correctly
rounded (``sqrt_f32``), and every other operation is one rounding in the
same order.
"""

from __future__ import annotations

from typing import Optional

import torch

from zeldaengine_tpu_torch.math.transforms import dot3, sqrt_f32


def _rows_times(x: torch.Tensor, m3: torch.Tensor) -> torch.Tensor:
    """``x @ m3.T`` for (N, 3) rows and a (K, 3) matrix, each entry summed
    by ``dot3``."""
    return dot3(x[:, None, :], m3[None, :, :])


def frustum_planes(view_proj: torch.Tensor) -> torch.Tensor:
    """Gribb-Hartmann plane extraction from a (4,4) view-proj matrix.

    Returns (6, 4) planes (a,b,c,d) with inside <=> a*x+b*y+c*z+d >= 0,
    for clip conventions -w<=x,y<=w, 0<=z<=w (Vulkan).
    """
    m = view_proj
    planes = torch.stack(
        [
            m[3] + m[0],  # left:   x >= -w
            m[3] - m[0],  # right:  x <=  w
            m[3] + m[1],  # bottom
            m[3] - m[1],  # top
            m[2],         # near:   z >= 0
            m[3] - m[2],  # far:    z <= w
        ]
    )
    norm = sqrt_f32(dot3(planes[:, :3], planes[:, :3]))[:, None]
    return planes / torch.clamp_min(norm, 1e-20)


def frustum_cull_spheres(planes: torch.Tensor, centers: torch.Tensor,
                         radii: torch.Tensor) -> torch.Tensor:
    """visible mask (M,): sphere intersects/inside all 6 planes."""
    d = _rows_times(centers, planes[:, :3]) + planes[None, :, 3]  # (M, 6)
    return torch.all(d >= -radii[:, None], dim=1)


def cone_cull(centers, radii, cone_axis, cone_cutoff, camera_pos):
    """meshopt-style backface cone test (sphere-apex conservative form):

    culled <=> dot(normalize(center - camera), axis) >= cutoff + r/|c-cam|
    Returns the *visible* mask.
    """
    to_c = centers - camera_pos
    dist = sqrt_f32(torch.clamp_min(dot3(to_c, to_c), 1e-20))
    dirn = to_c / dist[:, None]
    facing_away = dot3(dirn, cone_axis) >= cone_cutoff + radii / dist
    # cutoff >= 1 encodes "never cull" (degenerate normal spread)
    return ~(facing_away & (cone_cutoff < 1.0))


def meshlet_cull(
    meshlet_records: torch.Tensor,  # (M, 16) from MeshletSet.arrays()
    view_proj: torch.Tensor,
    camera_pos: torch.Tensor,
    model: Optional[torch.Tensor] = None,
    cone: bool = True,
) -> torch.Tensor:
    """Frustum + cone cull. Returns visible mask (M,).

    ``model`` (4,4) transforms bounds to world space (localToWorld).
    ``cone=False`` keeps the frustum test only - the shadow pass uses it
    with the LIGHT frustum (always exact: casters outside the shadow
    frustum cannot write the map) and adds the light-apex cone test only
    when the scene opts in (exact for closed meshes: a light-backfacing
    surface of a watertight mesh is never the nearest light-space depth).
    """
    centers = meshlet_records[:, 4:7]
    radii = meshlet_records[:, 7]
    axis = meshlet_records[:, 11:14]
    cutoff = meshlet_records[:, 14]
    if model is not None:
        m3 = model[:3, :3]
        centers = _rows_times(centers, m3) + model[:3, 3]
        axis = _rows_times(axis, m3)
        scale = sqrt_f32(dot3(m3.T, m3.T)).max()
        radii = radii * scale
    planes = frustum_planes(view_proj)
    vis = frustum_cull_spheres(planes, centers, radii)
    if cone:
        vis = vis & cone_cull(centers, radii, axis, cutoff, camera_pos)
    return vis


def expand_meshlet_mask(visible: torch.Tensor, tri_meshlet: torch.Tensor):
    """Per-triangle validity from a per-meshlet visible mask - the
    'compacted indirect draw list' consumed by the rasterizer (the
    analogue of vkCmdDrawIndexedIndirect over per-meshlet commands,
    ZeldaEngine.cpp:4216-4237)."""
    return visible[tri_meshlet.long()]
