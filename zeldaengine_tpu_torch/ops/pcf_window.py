"""Windowed PCF (``pcf_backend="pallas"``) as a CUDA kernel.

Kernel ``pcf_window`` (``csrc/pcf_window.cu``) replaces the JAX package's
``ops/pcf_pallas.py::_pcf_kernel`` (entry ``compute_pcf_pallas``). Each
(tile_h, tile_w) screen tile filters inside one (win, win) window of the
wrap-padded shadow map. The window's origin comes from the tile's
in-range-weighted mean shadow coordinate (the plain mean where no pixel
weighs), rounded half to even, aligned down to 8 rows and 128 columns;
taps outside the window clamp to its edge. The origins, the padding and
the per-pixel coordinates are computed here in PyTorch, exactly as the JAX
wrapper computes them around its kernel; the kernel (and its plain version
``pcf_window_taps_plain``) do the taps.

Approximate by design, and more than the JAX docstring says: the
128-column alignment can move the window up to 127 columns left of where
the mean put it, so taps clamp even when ``win`` covers the whole map.
Where every tap of a tile lies in its window the result is
``compute_pcf``'s. The TPU kernel reads depths through a bf16 hi/lo split
(good to ~2^-16 relative); this kernel reads the exact fp32 depth, which
is the function the TPU kernel's contract states.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from zeldaengine_tpu_torch.ops import _build
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel
from zeldaengine_tpu_torch.ops.shadow import SHADOW_IN_FACTOR, _tap_mean


class PcfWindowInputs(NamedTuple):
    """What the taps read: the wrap-padded map, one (wy, wx) origin per
    tile, and per pixel the padded-space texel coordinates, ``z - bias``
    and the in-range flag (1.0 / 0.0), all (H, W) f32."""

    sm_padded: torch.Tensor
    origins: torch.Tensor  # (n_ty, n_tx, 2) int32
    fx: torch.Tensor
    fy: torch.Tensor
    zcmp: torch.Tensor
    inrange: torch.Tensor


def pcf_window_inputs(shadowmap, shadow_coord, radius: int, scale: float,
                      bias: float, tile_h: int, tile_w: int, win: int,
                      valid: Optional[torch.Tensor] = None):
    """The JAX wrapper's math around its kernel (origins, padding,
    coordinates). Returns ``(PcfWindowInputs, win)``."""
    height, width = shadow_coord.shape[:2]
    dim = shadowmap.shape[-1]
    win = min(win, dim)
    n_ty, n_tx = height // tile_h, width // tile_w
    dev = shadow_coord.device

    w = shadow_coord[..., 3]
    safe_w = torch.where(torch.abs(w) > 1e-20, w, torch.ones_like(w))
    u = shadow_coord[..., 0] / safe_w
    v = shadow_coord[..., 1] / safe_w
    z = shadow_coord[..., 2] / safe_w
    w_post = w / safe_w
    zcmp = z - bias
    inrange = ((z > -1.0) & (z < 1.0) & (w_post > 0.0)).to(torch.float32)
    # The sampler wraps (REPEAT): fold coordinates into [0, dim).
    fx = torch.remainder(u * dim, float(dim))
    fy = torch.remainder(v * dim, float(dim))

    pad_t = int(math.ceil(scale * radius))
    weight = inrange
    if valid is not None:
        weight = weight * valid.to(torch.float32)

    def tiles(a):
        return a.reshape(n_ty, tile_h, n_tx, tile_w)

    def tile_mean(a):
        num = tiles(a * weight).sum(dim=(1, 3))
        den = tiles(weight).sum(dim=(1, 3))
        fallback = tiles(a).mean(dim=(1, 3))
        return torch.where(den > 0.5, num / torch.clamp_min(den, 1.0),
                           fallback)

    my = tile_mean(fy)
    mx = tile_mean(fx)
    # Origins aligned to 8 rows / 128 columns (the TPU's dynamic-slice
    # alignment); the map is padded so aligned origins exist everywhere.
    pad_y = ((pad_t + 7) // 8) * 8
    pad_x = ((pad_t + 127) // 128) * 128
    py_dim = ((dim + pad_y + pad_t + 2 + 7) // 8) * 8
    px_dim = ((dim + pad_x + pad_t + 2 + 127) // 128) * 128
    wy = torch.clamp(torch.round(my - win / 2).to(torch.int32) + pad_y,
                     0, py_dim - win)
    wx = torch.clamp(torch.round(mx - win / 2).to(torch.int32) + pad_x,
                     0, px_dim - win)
    wy = torch.div(wy, 8, rounding_mode="floor") * 8
    wx = torch.div(wx, 128, rounding_mode="floor") * 128
    origins = torch.stack([wy, wx], -1).to(torch.int32).contiguous()

    # mode="wrap" padding: padded index i reads (i - pad) mod dim.
    rows = torch.remainder(torch.arange(py_dim, device=dev) - pad_y, dim)
    cols = torch.remainder(torch.arange(px_dim, device=dev) - pad_x, dim)
    sm_padded = shadowmap[rows[:, None], cols[None, :]].contiguous()
    return PcfWindowInputs(
        sm_padded, origins, (fx + pad_x).contiguous(),
        (fy + pad_y).contiguous(), zcmp.contiguous(),
        inrange.contiguous()), win


def pcf_window_taps_plain(inp: PcfWindowInputs, radius: int, scale: float,
                          tile_h: int, tile_w: int, win: int):
    """Plain PyTorch version of kernel ``pcf_window`` (any device)."""
    height, width = inp.fx.shape
    org = inp.origins.repeat_interleave(tile_h, 0).repeat_interleave(
        tile_w, 1)  # (H, W, 2)
    wy, wx = org[..., 0], org[..., 1]
    px_dim = inp.sm_padded.shape[1]
    flat = inp.sm_padded.reshape(-1)
    ok = inp.inrange > 0.5
    one = torch.ones_like(inp.fx)
    shadowed = one * SHADOW_IN_FACTOR
    total = torch.zeros_like(inp.fx)
    count = 0
    for j in range(-radius, radius + 1):
        ry = torch.clamp(
            torch.floor(inp.fy + scale * j).to(torch.int32) - wy, 0, win - 1)
        for i in range(-radius, radius + 1):
            cx = torch.clamp(
                torch.floor(inp.fx + scale * i).to(torch.int32) - wx,
                0, win - 1)
            dist = flat[((wy + ry) * px_dim + wx + cx).long()]
            occluded = ok & (dist < inp.zcmp)
            total = total + torch.where(occluded, shadowed, one)
            count += 1
    return _tap_mean(total, count)


def pcf_window_taps(inp: PcfWindowInputs, radius: int, scale: float,
                    tile_h: int, tile_w: int, win: int,
                    backend: str = "auto"):
    """The taps of the windowed PCF: (H, W) f32. Tensors on the card go to
    kernel ``pcf_window``; CPU tensors (or ``backend="torch"``) to
    ``pcf_window_taps_plain``."""
    if not _use_kernel(inp.fx, backend):
        return pcf_window_taps_plain(inp, radius, scale, tile_h, tile_w, win)
    dev = inp.fx.device
    height, width = inp.fx.shape
    if height % tile_h or width % tile_w:
        raise ValueError(f"{height}x{width} is not a multiple of the tile "
                         f"{tile_h}x{tile_w}")
    n_ty, n_tx = height // tile_h, width // tile_w
    py_dim, px_dim = inp.sm_padded.shape
    if py_dim < win or px_dim < win:
        raise ValueError(f"window {win} exceeds the padded map "
                         f"{py_dim}x{px_dim}")
    ptrs = [_check(inp.sm_padded, "sm_padded", torch.float32, dev=dev),
            _check(inp.origins, "origins", torch.int32, (n_ty, n_tx, 2), dev)]
    ptrs += [_check(t, name, torch.float32, (height, width), dev)
             for t, name in ((inp.fx, "fx"), (inp.fy, "fy"),
                             (inp.zcmp, "zcmp"), (inp.inrange, "inrange"))]
    out = torch.empty((height, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _build.load().zk_pcf_window(
            ptrs[0], py_dim, px_dim, *ptrs[1:], out.data_ptr(), height,
            width, tile_h, tile_w, win, int(radius), float(scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pcf_window")
    pcf_window_taps.launches += 1
    return out


pcf_window_taps.launches = 0


def compute_pcf_pallas(shadowmap: torch.Tensor, shadow_coord: torch.Tensor,
                       radius: int = 2, scale: float = 1.5,
                       bias: float = 0.0, tile_h: int = 32,
                       tile_w: int = 128, win: int = 256,
                       valid: Optional[torch.Tensor] = None,
                       backend: str = "auto"):
    """Windowed PCF over an (H, W, 4) homogeneous shadow coordinate; H and
    W must be multiples of tile_h / tile_w (callers pad). (The TPU entry's
    ``sub_rows`` sized its kernel's inner loop and has no counterpart.)"""
    inp, win = pcf_window_inputs(shadowmap, shadow_coord, radius, scale,
                                 bias, tile_h, tile_w, win, valid)
    return pcf_window_taps(inp, radius, scale, tile_h, tile_w, win,
                           backend=backend)
