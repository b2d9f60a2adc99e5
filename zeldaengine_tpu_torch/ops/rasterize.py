"""Visibility-buffer triangle rasterization (plain PyTorch reference).

Replaces the fixed-function Vulkan rasterizer + depth test that the reference
engine gets for free (vkCmdDrawIndexed, ZeldaEngine.cpp:3545-3679):

- **Homogeneous 2D rasterization** (clip-space edge functions via the 3x3
  adjugate of the pixel-space vertex matrix). No near-plane clipping is
  needed: a pixel is covered by the visible part of a triangle iff all three
  adjugate dot products are >= 0 (after orientation normalization), which is
  exact for any sign pattern of vertex w.
- **Z-buffering is a pure min-reduction**: for each pixel, depth candidates
  across triangles reduce with ``min`` and the winning triangle id is kept.
- **Visibility buffer, not attribute buffer**: the rasterizer outputs only
  (depth, triangle_id) per pixel; attribute interpolation is deferred.

Math: with pixel-space homogeneous vertex matrix M (columns are vertices
(x_pix*w, y_pix*w, w)), the barycentric solve c = M^-1 @ (px, py, 1)
satisfies: pixel covered <=> all c_i >= 0; perspective-correct attribute
a(p) = sum(c_i a_i)/sum(c_i); NDC depth z(p) = sum(c_i z_i) (with
sum(c_i w_i) = 1). We use u = adj(M) @ p = det * c, normalized per triangle.

``triangle_setup`` feeds the pair rasterizer (``ops/rasterize_cuda.py``):
on the card it is one launch of kernel ``triangle_setup``
(``csrc/triangle_setup.cu``), elsewhere its plain version
``triangle_setup_plain``. The chunked brute-force rasterizers here are the
slow, obviously-right version the pair path is checked against, and the
frame's raster route under ``raster="jnp"`` (the JAX package's jnp
raster: ``passes/frame.py::raster_route``), plain PyTorch on every device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from zeldaengine_tpu_torch.math.transforms import fma_f32_plain
from zeldaengine_tpu_torch.ops import _build


class TriangleSetup(NamedTuple):
    """Per-triangle rasterization constants (all shapes (T, ...))."""

    edge: torch.Tensor  # (T, 3, 3) scaled adjugate rows; inside = all dots >= 0
    zc: torch.Tensor  # (T, 3) depth coefficients: depth = dot(u, zc)
    valid: torch.Tensor  # (T,) bool - in-front, non-degenerate, correctly wound
    bbox: torch.Tensor  # (T, 4) float32 pixel bbox (x0, y0, x1, y1), conservative
    # Conservative per-triangle MINIMUM NDC depth (0 when any vertex w is
    # near/behind zero - the projection is unbounded). Interpolated depth
    # is a convex combination of the vertices' z/w, so min_i(z_i/w_i)
    # bounds every covered pixel's depth from below. Drives the
    # front-to-back pair ordering of the pair rasterizer.
    zmin: Optional[torch.Tensor] = None  # (T,) float32 in [0, 1]


def edge_value(a, b, c, px, py):
    """Edge function a*px + b*py + c in the JAX package's compiled form on
    the CPU (where its goldens were rendered): fma(a, px, b*py) + c. The
    plain rasterizers' arithmetic: plain PyTorch on every device."""
    return fma_f32_plain(a, px, b * py) + c


def plane_depth(e0, e1, e2, z0, z1, z2):
    """Depth e0*z0 + e1*z1 + e2*z2 in the same compiled form:
    fma(e2, z2, fma(e0, z0, e1*z1)). Kernels ``pair_raster`` and
    ``pair_raster_fused`` evaluate both with ``__fmaf_rn``."""
    return fma_f32_plain(e2, z2, fma_f32_plain(e0, z0, e1 * z1))


def triangle_setup(
    clip: torch.Tensor,
    width: int,
    height: int,
    two_sided=False,
    valid_mask: Optional[torch.Tensor] = None,
    depth_bias: Optional[tuple] = None,
    backend: str = "auto",
) -> TriangleSetup:
    """``triangle_setup_plain``'s constants (arguments as there; the
    ``depth_bias`` factors Python numbers). Tensors on the card go to
    kernel ``triangle_setup`` (``csrc/triangle_setup.cu``) in one launch,
    bit for bit with the plain version; CPU tensors (or
    ``backend="torch"``) to ``triangle_setup_plain``."""
    from zeldaengine_tpu_torch.ops.rasterize_cuda import _use_kernel

    if not _use_kernel(clip, backend):
        return triangle_setup_plain(clip, width, height, two_sided,
                                    valid_mask, depth_bias)
    dev = clip.device
    clip = clip.to(torch.float32).contiguous()
    if clip.dim() != 3 or tuple(clip.shape[1:]) != (3, 4):
        raise ValueError(f"triangle_setup: expected (T, 3, 4) clip rows, "
                         f"got {tuple(clip.shape)}")
    if clip.data_ptr() % 16:  # the kernel reads 16-byte rows
        clip = clip.clone()
    n = clip.shape[0]

    def mask(m, name):
        if m.device != dev:
            raise ValueError(f"triangle_setup: {name} on {m.device}, the "
                             f"clip rows on {dev}")
        return m.to(torch.bool).expand(n).contiguous()

    two = mask(two_sided, "two_sided") if isinstance(
        two_sided, torch.Tensor) else None
    valid_in = None if valid_mask is None else mask(valid_mask, "valid_mask")
    slope_f = const_term = 0.0
    if depth_bias is not None:
        const_f, slope_f = depth_bias
        if isinstance(const_f, torch.Tensor) or isinstance(
                slope_f, torch.Tensor):
            raise ValueError("triangle_setup: depth_bias takes Python numbers")
        # Formed in fp64 and rounded to fp32 once (by ctypes), as
        # fma_f32_plain rounds the Python number.
        const_term = const_f * 1.1920929e-7
    edge = torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
    zc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    bbox = torch.empty((n, 4), dtype=torch.float32, device=dev)
    zmin = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return TriangleSetup(edge=edge, zc=zc, valid=valid, bbox=bbox,
                             zmin=zmin)
    with torch.cuda.device(dev):
        code = _build.load().zk_triangle_setup(
            clip.data_ptr(), None if two is None else two.data_ptr(),
            int(bool(two_sided)) if two is None else 0,
            None if valid_in is None else valid_in.data_ptr(), n,
            float(width), float(height), int(depth_bias is not None),
            float(slope_f), float(const_term), edge.data_ptr(),
            zc.data_ptr(), valid.data_ptr(), bbox.data_ptr(),
            zmin.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "triangle_setup")
    triangle_setup.launches += 1
    return TriangleSetup(edge=edge, zc=zc, valid=valid, bbox=bbox, zmin=zmin)


triangle_setup.launches = 0


def triangle_setup_plain(
    clip: torch.Tensor,
    width: int,
    height: int,
    two_sided=False,
    valid_mask: Optional[torch.Tensor] = None,
    depth_bias: Optional[tuple] = None,
) -> TriangleSetup:
    """Build edge/depth coefficients from clip-space triangle vertices
    (plain PyTorch version of kernel ``triangle_setup``, any device).

    Args:
      clip: (T, 3, 4) clip-space positions (x, y, z, w), Vulkan conventions
        (NDC x,y in [-1,1] with y down after the reference's proj Y flip,
        depth z/w in [0,1]).
      width/height: render-target size in pixels.
      two_sided: per-triangle bool tensor (or scalar) - disable backface
        culling (EXkRenderFlags::TwoSided; ZeldaEngine.cpp:5134).
      valid_mask: optional (T,) bool for padded/inactive triangles.
      depth_bias: optional (constant_factor, slope_factor) - Vulkan-style
        polygon depth bias applied at rasterization, as the shadow pass
        does with vkCmdSetDepthBias(1.25, 0, 7.5) (ZeldaEngine.cpp:
        3280-3287): written depth is offset by
        slope_factor * max(|dz/dx|, |dz/dy|) + constant_factor * r,
        with r = 2^-23 (D32_SFLOAT minimum resolvable difference).
    """
    clip = clip.to(torch.float32)
    x, y, z, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    # Fold viewport transform into homogeneous pixel coords:
    # x_pix = (x/w * 0.5 + 0.5) * width  =>  xp = (0.5x + 0.5w) * width
    xp = (0.5 * x + 0.5 * w) * width
    yp = (0.5 * y + 0.5 * w) * height

    x0, x1, x2 = xp[..., 0], xp[..., 1], xp[..., 2]
    y0, y1, y2 = yp[..., 0], yp[..., 1], yp[..., 2]
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]

    # Adjugate of M = [[x0,x1,x2],[y0,y1,y2],[w0,w1,w2]] (columns=vertices):
    # row i from vertices i+1 and i+2 (mod 3), [y1 w2 - y2 w1, x2 w1 - x1 w2,
    # x1 y2 - x2 y1] for row 0. Multiply-adds are fused where XLA fuses them
    # in the JAX package's compiled frame (on the CPU, where its goldens
    # were rendered): each 2x2 minor a*b - c*d as fma(a, b, -(c*d)), the
    # determinant as fma(x2, ., fma(x0, ., x1 * .)). Near-degenerate
    # triangles (the shadow pass is full of them) amplify the one-rounding
    # difference.
    def nxt(t, k):  # vertex i + k of row i
        return torch.roll(t, -k, dims=-1)

    xa, xb = nxt(xp, 1), nxt(xp, 2)
    ya, yb = nxt(yp, 1), nxt(yp, 2)
    wa, wb = nxt(w, 1), nxt(w, 2)
    adj = fma_f32_plain(torch.stack([ya, xb, xa], -1),
                        torch.stack([wb, wa, yb], -1),
                        -(torch.stack([yb, xa, xb], -1)
                          * torch.stack([wa, wb, ya], -1)))  # (T, 3, 3)
    det = fma_f32_plain(x2, adj[..., 2, 0],
                        fma_f32_plain(x0, adj[..., 0, 0], x1 * adj[..., 1, 0]))

    # Orientation: Vulkan front face is COUNTER_CLOCKWISE in y-down
    # framebuffer coords (ZeldaEngine.cpp:5118), which in this matrix
    # construction is det < 0. Normalize edges by sign(det) so interior
    # pixels always satisfy u_i >= 0.
    one = torch.ones_like(det)
    sign = torch.where(det >= 0, one, -one)
    front = det < 0
    two_sided = torch.as_tensor(two_sided, dtype=torch.bool,
                                device=det.device).broadcast_to(det.shape)
    keep = torch.where(two_sided, torch.abs(det) > 0, front)
    if valid_mask is not None:
        keep = keep & valid_mask
    # Reject triangles entirely behind the camera (all w <= 0): their
    # adjugate test would otherwise accept the mirrored projection.
    keep = keep & torch.any(w > 0, dim=-1)

    # Condition the coefficients: scale rows so |entries| ~ 1.
    scale = torch.amax(torch.abs(adj), dim=(-2, -1))
    scale = torch.where(scale > 0, scale, one)
    edge = adj * (sign / scale)[..., None, None]
    det_scaled = det * sign / scale  # positive
    safe_det = torch.where(torch.abs(det_scaled) > 1e-20, det_scaled, one)
    # depth(p) = dot(u, z)/det_scaled with u = edge @ p; fold 1/det into zc.
    inv_det = 1.0 / safe_det
    zc = z * inv_det[..., None]

    keep = keep & (torch.abs(det_scaled) > 1e-20)

    if depth_bias is not None:
        const_f, slope_f = depth_bias
        # Screen-space depth gradient: depth(p) = dot(u, zc) with
        # u = edge @ (px, py, 1)  =>  dz/dpx = sum_i zc_i * edge[i, 0].
        # The sum cancels heavily (zc ~ 1/det while the gradient is small),
        # so its accumulation order is part of the result: it is the JAX
        # package's compiled form, a fused multiply-add chain over i, as
        # are the bias (fma(slope, slope_f, const)) and the biased zc
        # (fma(z, 1/det, bias/det * w)).
        zrow = zc[..., 0, None] * edge[..., 0, :]
        for i in (1, 2):
            zrow = fma_f32_plain(zc[..., i, None], edge[..., i, :], zrow)
        slope = torch.maximum(torch.abs(zrow[..., 0]), torch.abs(zrow[..., 1]))
        bias = fma_f32_plain(slope, slope_f, const_f * 1.1920929e-7)
        # Add a constant to the interpolated depth: with the scaled edges,
        # sum(u_i * w_i) = det_scaled, so zc_i += bias * w_i / det_scaled
        # shifts depth(p) by exactly bias.
        zc = fma_f32_plain(z, inv_det[..., None],
                           (bias / safe_det)[..., None] * w)

    # Conservative screen bbox of the visible region. If any w is near/behind
    # zero the projection is unbounded -> full screen.
    w_ok = torch.all(w > 1e-6, dim=-1)
    w_safe = torch.where(torch.abs(w) > 1e-6, w, torch.ones_like(w))
    px = xp / w_safe
    py = yp / w_safe
    zero = torch.zeros_like(det)
    fx0 = torch.where(w_ok, torch.amin(px, -1), zero)
    fy0 = torch.where(w_ok, torch.amin(py, -1), zero)
    fx1 = torch.where(w_ok, torch.amax(px, -1), zero + float(width))
    fy1 = torch.where(w_ok, torch.amax(py, -1), zero + float(height))
    bbox = torch.stack(
        [
            torch.clamp(fx0, 0.0, float(width)),
            torch.clamp(fy0, 0.0, float(height)),
            torch.clamp(fx1, 0.0, float(width)),
            torch.clamp(fy1, 0.0, float(height)),
        ],
        -1,
    )
    # Zero-area bbox for culled triangles so binning skips them.
    bbox = torch.where(keep[..., None], bbox, torch.zeros_like(bbox))

    # Conservative minimum NDC depth (see TriangleSetup.zmin); near-plane
    # crossers get 0. A positive depth_bias only raises depth, so the
    # unbiased bound stays valid.
    z_over_w = z / w_safe
    zmin = torch.where(w_ok, torch.amin(z_over_w, dim=-1), zero)
    zmin = torch.clamp(zmin, 0.0, 1.0)
    # A zero bound is +0.0, as the JAX package's clip leaves it: a vertex
    # depth of -0.0 would keep its sign through amin and clamp here.
    zmin = torch.where(zmin == 0.0, 0.0, zmin)

    return TriangleSetup(edge=edge, zc=zc, valid=keep, bbox=bbox, zmin=zmin)


def _pixel_grid(height: int, width: int, x0=0, y0=0, device=None):
    """Pixel-center coordinates ((H,W) each), offset by an origin.

    Offsets are added in INTEGER pixel space before the float convert so a
    row band at y0 produces bit-identical coordinates to the same rows of a
    full-frame grid.
    """
    py = (torch.arange(height, dtype=torch.int32, device=device)[:, None]
          + int(y0)).to(torch.float32) + 0.5
    px = (torch.arange(width, dtype=torch.int32, device=device)[None, :]
          + int(x0)).to(torch.float32) + 0.5
    return px.expand(height, width), py.expand(height, width)


def _coverage_chunk(edge, zc, valid, px, py):
    """Depth candidates for a chunk of triangles over a pixel block.

    Returns (depth, covered) of shape (K, H, W).
    """
    # u_i = edge[i,0]*px + edge[i,1]*py + edge[i,2]
    e = edge_value(edge[:, :, 0, None, None], edge[:, :, 1, None, None],
                   edge[:, :, 2, None, None], px, py)  # (K, 3, H, W)
    inside = torch.all(e >= 0.0, dim=1)  # (K, H, W)
    # Reject the fully-degenerate all-zero case (u = 0 vector).
    esum = e[:, 0] + e[:, 1] + e[:, 2]
    inside = inside & (esum > 0.0)
    z = [zc[:, i, None, None] for i in range(3)]
    depth = plane_depth(e[:, 0], e[:, 1], e[:, 2], *z)
    # Vulkan depth clip: 0 <= z_ndc <= 1 (z < 0 is behind the near plane).
    covered = inside & (depth >= 0.0) & (depth <= 1.0) & valid[:, None, None]
    depth = torch.where(covered, depth, torch.full_like(depth, float("inf")))
    return depth, covered


def rasterize_visibility(
    setup: TriangleSetup,
    height: int,
    width: int,
    chunk: int = 64,
    init_depth: Optional[torch.Tensor] = None,
    y0=0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize to a visibility buffer (brute force, chunked): the
    GBuffer, forward and dome passes under ``raster="jnp"``.

    Returns:
      depth: (H, W) float32 NDC depth; pixels with no coverage hold the
        clear value 1.0 (or ``init_depth``).
      tri_id: (H, W) int32 winning triangle index, -1 where uncovered.
    """
    dev = setup.edge.device
    n_tris = setup.edge.shape[0]
    px, py = _pixel_grid(height, width, y0=y0, device=dev)
    if init_depth is None:
        init_depth = torch.ones((height, width), dtype=torch.float32,
                                device=dev)
    best_depth = init_depth.clone()
    best_tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    for sl in range(0, n_tris, chunk):
        depth, _ = _coverage_chunk(
            setup.edge[sl:sl + chunk], setup.zc[sl:sl + chunk],
            setup.valid[sl:sl + chunk], px, py)
        # Per-pixel winner within the chunk (min depth; ties -> lower index).
        local_best, local_arg = torch.min(depth, dim=0)
        # torch.min returns *an* index of the minimum; take the lowest.
        tie = depth == local_best[None]
        ids = torch.arange(depth.shape[0], device=dev)[:, None, None]
        local_arg = torch.where(
            tie, ids, torch.full_like(ids, depth.shape[0])).amin(dim=0)
        take = local_best < best_depth
        best_depth = torch.where(take, local_best, best_depth)
        best_tri = torch.where(take, (local_arg + sl).to(torch.int32),
                               best_tri)
    return best_depth, best_tri


def rasterize_depth(
    setup: TriangleSetup,
    height: int,
    width: int,
    chunk: int = 64,
    y0=0,
) -> torch.Tensor:
    """Depth-only rasterization (the shadowmap pass, XkShadowmapPass
    ZeldaEngine.cpp:1372/:3239), brute force: the shadow map under
    ``raster="jnp"``. Returns (H, W) float32, clear = 1.0."""
    dev = setup.edge.device
    n_tris = setup.edge.shape[0]
    px, py = _pixel_grid(height, width, y0=y0, device=dev)
    best = torch.ones((height, width), dtype=torch.float32, device=dev)
    for sl in range(0, n_tris, chunk):
        depth, _ = _coverage_chunk(
            setup.edge[sl:sl + chunk], setup.zc[sl:sl + chunk],
            setup.valid[sl:sl + chunk], px, py)
        best = torch.minimum(best, torch.amin(depth, dim=0))
    return best


def interpolation_coeffs(setup: TriangleSetup, tri_id: torch.Tensor,
                         height: int, width: int,
                         y0=0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel perspective-correct barycentrics from a visibility buffer.

    Gathers the winning triangle's edge coefficients and normalizes:
    lambda_i = u_i / sum(u). Returns (bary (H,W,3), covered (H,W) bool).
    """
    covered = tri_id >= 0
    safe_id = torch.clamp_min(tri_id, 0).long()
    e = setup.edge[safe_id]  # (H, W, 3, 3)
    px, py = _pixel_grid(height, width, y0=y0, device=tri_id.device)
    u = e[..., 0] * px[..., None] + e[..., 1] * py[..., None] + e[..., 2]
    esum = torch.sum(u, dim=-1, keepdim=True)
    bary = u / torch.where(torch.abs(esum) > 1e-20, esum,
                           torch.ones_like(esum))
    return bary, covered
