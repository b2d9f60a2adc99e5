"""Tile-culled point lighting as a CUDA kernel.

Kernel ``point_lights`` (``csrc/point_lights.cu``) replaces the JAX
package's ``ops/lighting_pallas.py::_point_kernel`` (entry
``point_lighting_pallas``): every pixel of a (block_h, 128) block walks
that block's culled light list (``cull_point_lights_tiled`` with tile
block_h x 128) in ascending order and adds ``rad * lc * (dc * kd + fr)``
(``pbr.default_lit_bxdf`` x ``pbr.apply_point_light``) onto the
directional partial sum it is given. Lights past a block's count are
never touched, so a light the cull skipped (falloff exactly 0 beyond its
radius) leaves the sum as the unrolled loop would.

``point_lighting_plain`` mirrors the kernel operation for operation. It
is not the unrolled loop of ``ops/lighting.py``: like the TPU kernel it
does not re-normalise ``n`` (the caller passes it normalised), hoists the
roughness-only terms out of the light loop, writes ``pow(x, 5)`` as
repeated squaring and divides where the reference divides.
"""

from __future__ import annotations

import numpy as np
import torch

from zeldaengine_tpu_torch.ops import _build
from zeldaengine_tpu_torch.ops.pbr import F0_DIELECTRIC, PI
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel

# fr_disney_diffuse's energy factor 1 / 1.51: computed once in double and
# rounded to fp32 by the multiply, as in the TPU kernel and the CUDA
# source (static_cast<float>(1.0 / 1.51)).
E_SCALE = 1.0 / 1.51
# f_schlick(F0, f90, u) with f90 = saturate(50 * F0) = 1.0: the span
# (f90 - F0) is one fp32 subtraction.
F_SPAN = float(np.float32(min(50.0 * F0_DIELECTRIC, 1.0))
               - np.float32(F0_DIELECTRIC))
BLOCK_W = 128


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def point_lighting_plain(acc, diffuse_color, roughness, n, p, v, ndotv,
                         point_lights, tile_idx, tile_cnt,
                         block_h: int = 24):
    """Plain PyTorch version of kernel ``point_lights`` (any device)."""
    h, w = roughness.shape
    n_by, n_bx = -(-h // block_h), w // BLOCK_W
    ph = n_by * block_h
    lt = point_lights.reshape(point_lights.shape[0], 16).to(torch.float32)

    def blk(x):  # (H, W[, C]) -> (n_by, block_h, n_bx, 128[, C])
        if ph != h:
            pad = (0, 0) * (x.ndim - 1) + (0, ph - h)
            x = torch.nn.functional.pad(x, pad)
        return x.reshape(n_by, block_h, n_bx, BLOCK_W, *x.shape[2:])

    def planes(x3):
        x = blk(x3)
        return x[..., 0], x[..., 1], x[..., 2]

    a0, a1, a2acc = planes(acc)
    dc0, dc1, dc2 = planes(diffuse_color)
    n0, n1, n2 = planes(n)
    p0, p1, p2 = planes(p)
    v0, v1, v2 = planes(v)
    rough = blk(roughness)
    nv = blk(ndotv)

    # Hoisted roughness-only terms (identical for every light).
    a2 = rough * rough
    one_m_a2 = 1.0 - a2
    e_bias = 0.5 * rough
    e_factor = (1.0 - rough) + E_SCALE * rough
    pow5_nv = _pow5(1.0 - nv)

    k_dyn = int(tile_cnt.max()) if tile_cnt.numel() else 0
    for k in range(k_dyn):
        on = (k < tile_cnt)[:, None, :, None]  # (n_by, 1, n_bx, 1)
        lk = lt[tile_idx[:, :, k].long()][:, None, :, None, :]

        t0 = lk[..., 0] - p0
        t1 = lk[..., 1] - p1
        t2 = lk[..., 2] - p2
        d2 = t0 * t0 + t1 * t1 + t2 * t2
        dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
        l0 = t0 / dist
        l1 = t1 / dist
        l2 = t2 / dist
        h0 = v0 + l0
        h1 = v1 + l1
        h2 = v2 + l2
        hn = torch.sqrt(torch.clamp_min(h0 * h0 + h1 * h1 + h2 * h2, 1e-20))
        h0 = h0 / hn
        h1 = h1 / hn
        h2 = h2 / hn
        ldoth = torch.clamp(l0 * h0 + l1 * h1 + l2 * h2, 0.0, 1.0)
        ndoth = torch.clamp(n0 * h0 + n1 * h1 + n2 * h2, 0.0, 1.0)
        ndotl = torch.clamp(n0 * l0 + n1 * l1 + n2 * l2, 0.0, 1.0)

        f = F0_DIELECTRIC + F_SPAN * _pow5(1.0 - ldoth)
        ggxv = ndotl * torch.sqrt(nv * nv * one_m_a2 + a2)
        ggxl = nv * torch.sqrt(ndotl * ndotl * one_m_a2 + a2)
        ggx = ggxv + ggxl
        pos = ggx > 0.0
        vis = torch.where(pos, 0.5 / torch.where(pos, ggx, 1.0), 0.0)
        fd_ggx = (ndoth * a2 - ndoth) * ndoth + 1.0
        d_ndf = a2 / (PI * fd_ggx * fd_ggx)
        fr = f * d_ndf * vis
        fd90 = e_bias + 2.0 * ldoth * ldoth * rough
        light_scatter = 1.0 + (fd90 - 1.0) * _pow5(1.0 - ndotl)
        view_scatter = 1.0 + (fd90 - 1.0) * pow5_nv
        fd = light_scatter * view_scatter * e_factor
        kd = (1.0 - f) * fd

        att = 1.0 - torch.clamp(
            dist / torch.clamp_min(lk[..., 11], 1e-6), 0.0, 1.0)
        rad = ndotl * lk[..., 7] * att
        a0 = torch.where(on, a0 + rad * lk[..., 4] * (dc0 * kd + fr), a0)
        a1 = torch.where(on, a1 + rad * lk[..., 5] * (dc1 * kd + fr), a1)
        a2acc = torch.where(on, a2acc + rad * lk[..., 6] * (dc2 * kd + fr),
                            a2acc)
    out = torch.stack([a0, a1, a2acc], -1).reshape(ph, w, 3)
    return out[:h]


def point_lighting(acc, diffuse_color, roughness, n, p, v, ndotv,
                   point_lights, tile_idx, tile_cnt, block_h: int = 24,
                   backend: str = "auto"):
    """Accumulate tile-culled point lights onto ``acc`` (H, W, 3).

    ``tile_idx`` (Ty, Tx, K) / ``tile_cnt`` (Ty, Tx) must come from
    ``cull_point_lights_tiled`` with tile ``block_h`` x 128; ``n`` must be
    normalised. Returns a new (H, W, 3) tensor. Tensors on the card go to
    kernel ``point_lights``; CPU tensors (or ``backend="torch"``) to
    ``point_lighting_plain``.
    """
    h, w = roughness.shape
    if w % BLOCK_W:
        raise ValueError(f"width {w} is not a multiple of {BLOCK_W}")
    n_by, n_bx = -(-h // block_h), w // BLOCK_W
    if tuple(tile_cnt.shape) != (n_by, n_bx) or tile_idx.ndim != 3 \
            or tuple(tile_idx.shape[:2]) != (n_by, n_bx):
        raise ValueError(
            f"tile lists {tuple(tile_idx.shape)} / {tuple(tile_cnt.shape)} "
            f"do not match {n_by}x{n_bx} blocks of {block_h}x{BLOCK_W}")
    if not _use_kernel(acc, backend):
        return point_lighting_plain(acc, diffuse_color, roughness, n, p, v,
                                    ndotv, point_lights, tile_idx, tile_cnt,
                                    block_h=block_h)
    dev = acc.device
    lt = point_lights.reshape(point_lights.shape[0], 16)
    ptrs = [_check(t, name, torch.float32, (h, w, 3), dev) for t, name in
            ((acc, "acc"), (diffuse_color, "diffuse_color"), (n, "n"),
             (p, "p"), (v, "v"))]
    ptrs += [_check(t, name, torch.float32, (h, w), dev) for t, name in
             ((roughness, "roughness"), (ndotv, "ndotv"))]
    lt_ptr = _check(lt, "point_lights", torch.float32, dev=dev)
    idx_ptr = _check(tile_idx, "tile_idx", torch.int32, dev=dev)
    cnt_ptr = _check(tile_cnt, "tile_cnt", torch.int32, dev=dev)
    out = torch.empty_like(acc)
    with torch.cuda.device(dev):
        code = _build.load().zk_point_lights(
            *ptrs, lt_ptr, idx_ptr, cnt_ptr, tile_idx.shape[2],
            h, w, block_h, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "point_lights")
    point_lighting.launches += 1
    return out


point_lighting.launches = 0
