"""Shadow mapping: bias-matrix projection + PCF filtering.

Ports Common.glsl:294-342 (BiasMat, ComputeShadowCoord, ShadowDepthProject,
ComputePCF). ``compute_pcf`` is the plain 25-gather filter: the exact
reference every PCF backend is held against, and the version that runs for
CPU tensors. The kernel that serves the frame on the card lives in
``ops/pcf_cuda.py``.

The opt-in backends of ``EngineConfig.pcf_backend`` follow: the row-table
filters (``compute_pcf_packed``, exact tap for tap), the same over the
tables of kernels ``pcf_window_table`` / ``pcf_window2d_table``
(``compute_pcf_packed_roll`` / ``compute_pcf_window_roll``, exact) and the
half-resolution filter with a 2x upsample (``compute_pcf_half``,
approximate by one tap quantum along penumbra edges).
"""

from __future__ import annotations

import math

import torch

from zeldaengine_tpu_torch.ops.pcf_tables import (
    build_pcf_window2d_table,
    build_pcf_window_table,
)

SHADOW_IN_FACTOR = 0.1  # ShadowDepthProject: factor when occluded (:315)


def _tap_mean(total: torch.Tensor, count: int) -> torch.Tensor:
    """total / count as an IEEE division on every device. PyTorch on CUDA
    multiplies by the reciprocal of a host scalar divisor (one ulp off the
    quotient at many pixels); a divisor on the tensor's device divides."""
    return total / total.new_tensor(float(count))


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
    return _tap_mean(total, count)


def _window_span(radius: int, scale: float):
    """(lo, hi): the x (and y) texel offsets the taps reach from the
    pixel's own base texel."""
    return int(math.floor(-scale * radius)), int(math.ceil(scale * radius))


def _coords(shadow_coord, dim_y: int, dim_x: int, bias: float):
    """Divide by w; (in_range, z_cmp, fx, fy) as every filter uses them."""
    w = shadow_coord[..., 3, None]
    sc = shadow_coord / torch.where(torch.abs(w) > 1e-20, w,
                                    torch.ones_like(w))
    z = sc[..., 2]
    in_range = (z > -1.0) & (z < 1.0) & (sc[..., 3] > 0.0)
    return in_range, z - bias, sc[..., 0] * dim_x, sc[..., 1] * dim_y


def compute_pcf_packed(shadowmap: torch.Tensor, shadow_coord: torch.Tensor,
                       radius: int = 2, scale: float = 1.5,
                       bias: float = 0.0, batch_rows: bool = False,
                       _ablate_const_table: bool = False):
    """ComputePCF through a row-window table: exact (tap for tap equal to
    ``compute_pcf``) at (2r+1) row gathers per pixel.

    Row (y * wp + x) of the table holds sm[y, (x + lo .. x + hi) mod D]
    (wp = D + hi - lo, the wrap-padded row length); the x taps of one tap
    row then resolve from the gathered row with static channel selects.
    ``batch_rows`` gathers the (2r+1) rows in one indexing op.
    ``_ablate_const_table`` (the frame's ablation "pcfbuild", a
    diagnostic) skips the table build and taps a broadcast of the map's
    first row segment instead."""
    lo, hi = _window_span(radius, scale)
    w_win = hi - lo + 1
    dim_y, dim_x = shadowmap.shape[-2], shadowmap.shape[-1]
    wp = dim_x + w_win - 1
    span = (dim_y - 1) * wp + dim_x
    if _ablate_const_table:
        table = shadowmap[:1, :w_win].broadcast_to(span, w_win)
    else:
        cols = torch.remainder(
            torch.arange(wp, device=shadowmap.device) + lo, dim_x)
        flat = shadowmap[:, cols].reshape(-1)  # the x-wrap-padded map
        table = torch.stack([flat[dx:dx + span] for dx in range(w_win)], 1)
    return _pcf_taps_from_rows(table, wp, dim_y, dim_x, shadow_coord,
                               radius, scale, bias, lo,
                               batch_rows=batch_rows)


def _pcf_taps_from_rows(table, wp: int, dim_y: int, dim_x: int,
                        shadow_coord, radius: int, scale: float,
                        bias: float, lo: int, batch_rows: bool = False):
    """The taps over an x-window row table: table[y * wp + x] holds
    sm[y, x + lo .. x + lo + w - 1] (wrap addressing).

    floor(fx + scale * ox) - floor(fx) takes at most two values for a
    fractional part in [0, 1), split at ceil(s) - s (s = scale * ox): each
    x tap is a static channel or a two-way select. The 0.1 / 1.0 map stays
    per tap, summed in tap order (bitwise equal to ``compute_pcf``)."""
    in_range, z_cmp, fx, fy = _coords(shadow_coord, dim_y, dim_x, bias)
    xm = torch.remainder(torch.floor(fx).to(torch.int32), dim_x)
    oys = list(range(-radius, radius + 1))

    def row_index(oy):
        iy = torch.remainder(torch.floor(fy + scale * oy).to(torch.int32),
                             dim_y)
        return (iy * wp + xm).long()

    if batch_rows:
        rows_all = table[torch.stack([row_index(oy) for oy in oys], 0)]
    frx = fx - torch.floor(fx)
    one = torch.ones_like(z_cmp)
    shadowed = one * SHADOW_IN_FACTOR
    total = torch.zeros_like(z_cmp)
    count = 0
    for k, oy in enumerate(oys):
        row = rows_all[k] if batch_rows else table[row_index(oy)]
        for ox in range(-radius, radius + 1):
            so = scale * ox
            c0 = int(math.floor(so)) - lo
            if so == math.floor(so):
                dist = row[..., c0]
            else:
                thr = math.ceil(so) - so
                dist = torch.where(frx >= thr, row[..., c0 + 1],
                                   row[..., c0])
            total = total + torch.where(dist < z_cmp, shadowed, one)
            count += 1
    total = torch.where(in_range, total, torch.full_like(total, count))
    return _tap_mean(total, count)


def compute_pcf_packed_roll(shadowmap: torch.Tensor,
                            shadow_coord: torch.Tensor,
                            radius: int = 2, scale: float = 1.5,
                            bias: float = 0.0, backend: str = "auto"):
    """``compute_pcf_packed`` over the 8-wide table of kernel
    ``pcf_window_table``; exact tap for tap. Windows wider than 8 texels
    take ``compute_pcf_packed``."""
    lo, hi = _window_span(radius, scale)
    if hi - lo + 1 > 8:
        return compute_pcf_packed(shadowmap, shadow_coord, radius=radius,
                                  scale=scale, bias=bias)
    dim_y, dim_x = shadowmap.shape[-2], shadowmap.shape[-1]
    table = build_pcf_window_table(shadowmap, lo=lo, hi=hi, backend=backend)
    return _pcf_taps_from_rows(table, dim_x, dim_y, dim_x, shadow_coord,
                               radius, scale, bias, lo)


def compute_pcf_window_roll(shadowmap: torch.Tensor,
                            shadow_coord: torch.Tensor,
                            radius: int = 2, scale: float = 1.5,
                            bias: float = 0.0, backend: str = "auto"):
    """ComputePCF with ONE gather per pixel from the (w x 8) window table
    of kernel ``pcf_window2d_table``: all taps resolve from the fetched
    row with at most 4-way static-channel selects. Exact tap for tap;
    windows wider than 8 texels take ``compute_pcf_packed``."""
    lo, hi = _window_span(radius, scale)
    w_win = hi - lo + 1
    if w_win > 8:
        return compute_pcf_packed(shadowmap, shadow_coord, radius=radius,
                                  scale=scale, bias=bias)
    dim_y, dim_x = shadowmap.shape[-2], shadowmap.shape[-1]
    table = build_pcf_window2d_table(shadowmap, lo_x=lo, lo_y=lo, w_y=w_win,
                                     backend=backend)
    in_range, z_cmp, fx, fy = _coords(shadow_coord, dim_y, dim_x, bias)
    xb = torch.floor(fx)
    yb = torch.floor(fy)
    xm = torch.remainder(xb.to(torch.int32), dim_x)
    ym = torch.remainder(yb.to(torch.int32), dim_y)
    row = table[(ym * dim_x + xm).long()]  # (..., w_win * 8): the gather

    frx = fx - xb
    fry = fy - yb
    one = torch.ones_like(z_cmp)
    shadowed = one * SHADOW_IN_FACTOR
    total = torch.zeros_like(z_cmp)
    count = 0
    for oy in range(-radius, radius + 1):
        so_y = scale * oy
        cy0 = int(math.floor(so_y)) - lo
        thr_y = None if so_y == math.floor(so_y) else math.ceil(so_y) - so_y
        for ox in range(-radius, radius + 1):
            so_x = scale * ox
            cx0 = int(math.floor(so_x)) - lo
            if so_x == math.floor(so_x):
                if thr_y is None:
                    dist = row[..., cy0 * 8 + cx0]
                else:
                    dist = torch.where(fry >= thr_y,
                                       row[..., (cy0 + 1) * 8 + cx0],
                                       row[..., cy0 * 8 + cx0])
            else:
                thr_x = math.ceil(so_x) - so_x
                if thr_y is None:
                    dist = torch.where(frx >= thr_x,
                                       row[..., cy0 * 8 + cx0 + 1],
                                       row[..., cy0 * 8 + cx0])
                else:
                    right = frx >= thr_x
                    dx_lo = torch.where(right, row[..., cy0 * 8 + cx0 + 1],
                                        row[..., cy0 * 8 + cx0])
                    dx_hi = torch.where(right,
                                        row[..., (cy0 + 1) * 8 + cx0 + 1],
                                        row[..., (cy0 + 1) * 8 + cx0])
                    dist = torch.where(fry >= thr_y, dx_hi, dx_lo)
            occluded = in_range & (dist < z_cmp)
            total = total + torch.where(occluded, shadowed, one)
            count += 1
    return _tap_mean(total, count)


def compute_pcf_half(shadowmap: torch.Tensor, shadow_coord: torch.Tensor,
                     radius: int = 2, scale: float = 1.5,
                     bias: float = 0.0, upsample: str = "linear",
                     inner: str = "packed", backend: str = "auto"):
    """ComputePCF at half resolution + 2x upsample.

    The exact row-table taps run on the 2x2 means of the homogeneous
    coordinates, and the factor is upsampled (``"linear"``: separable
    tent, ``"nearest"``). Off the full-resolution factor by one tap
    quantum along penumbra edges. ``inner="window_roll"`` takes the taps
    from the window table of kernel ``pcf_window2d_table`` (when the
    map's width is a multiple of 128). Odd shapes take the full-resolution
    ``compute_pcf_packed`` (the JAX package's own rule)."""
    h, w = shadow_coord.shape[:2]
    if h % 2 or w % 2 or shadow_coord.ndim != 3:
        return compute_pcf_packed(shadowmap, shadow_coord, radius=radius,
                                  scale=scale, bias=bias)
    if inner not in ("packed", "window_roll"):
        raise NotImplementedError(
            f"compute_pcf_half(inner={inner!r}) is not ported yet "
            "(ROADMAP.md A9: ops/shadow.py variants)")
    q = shadow_coord.reshape(h // 2, 2, w // 2, 2, 4)
    # The 2x2 mean, summed in the reference's reduction order.
    sc = (((q[:, 0, :, 0] + q[:, 0, :, 1]) + q[:, 1, :, 0])
          + q[:, 1, :, 1]) / 4.0
    if inner == "window_roll" and shadowmap.shape[-1] % 128 == 0:
        f = compute_pcf_window_roll(shadowmap, sc, radius=radius,
                                    scale=scale, bias=bias, backend=backend)
    else:
        f = compute_pcf_packed(shadowmap, sc, radius=radius, scale=scale,
                               bias=bias)
    if upsample == "nearest":
        return f[:, None, :, None].expand(h // 2, 2, w // 2, 2).reshape(h, w)

    # Separable 2x tent: even output 2q reads 0.75 f[q] + 0.25 f[q-1], odd
    # 0.75 f[q] + 0.25 f[q+1] (edge-clamped).
    def up_axis0(x):
        prev = torch.cat([x[:1], x[:-1]], 0)
        nxt = torch.cat([x[1:], x[-1:]], 0)
        pair = torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt],
                           1)
        return pair.reshape(x.shape[0] * 2, *x.shape[1:])

    f = up_axis0(f)  # (h, w/2)
    return up_axis0(f.T).T.contiguous()  # (h, w)
