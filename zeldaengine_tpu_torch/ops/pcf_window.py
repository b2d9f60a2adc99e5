"""Windowed PCF (``pcf_backend="pallas"``) as one CUDA kernel.

Kernel ``pcf_window`` (``csrc/pcf_window.cu``) replaces the JAX package's
``ops/pcf_pallas.py::_pcf_kernel`` and the wrapper arithmetic around it
(entry ``compute_pcf_pallas``). Each (tile_h, tile_w) screen tile filters
inside one (win, win) window of the wrap-padded shadow map. The window's
origin comes from the tile's in-range x valid weighted mean texel
coordinate (the plain mean where no pixel weighs), rounded half to even,
aligned down to 8 rows and 128 columns; taps outside the window clamp to
its edge. The kernel reads the (H, W, 4) coordinate, the valid mask and the
unpadded map and writes the (H, W) factor: a block per tile reduces the
origin, then taps. ``compute_pcf_pallas_plain`` is the same function in
PyTorch, in the kernel's order of summation (``tile_sums_plain``) and with
its wrapped addressing of the unpadded map (``wrap_window``).

Approximate by design, and more than the JAX docstring says: the
128-column alignment can move the window up to 127 columns left of where
the mean put it, so taps clamp even when ``win`` covers the whole map.
Where every tap of a tile lies in its window the result is
``compute_pcf``'s. The TPU kernel reads depths through a bf16 hi/lo split
(good to ~2^-16 relative); this kernel reads the exact fp32 depth, which
is the function the TPU kernel's contract states. The tile sums are taken
in another order than the JAX wrapper's, so a tile's mean can differ from
it in the last bits; an origin moves only where that crosses a rounding
and an alignment boundary.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from zeldaengine_tpu_torch.ops import _build
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel
from zeldaengine_tpu_torch.ops.shadow import SHADOW_IN_FACTOR, _tap_mean

# A thread of kernel pcf_window takes at most this many pixels of its tile;
# a block has at most MAX_THREADS threads (csrc/pcf_window.cu).
PIXELS_A_THREAD = 8
MAX_THREADS = 512
# Texels of a tile's tap box the kernel copies into shared memory (at most
# 8192, the kernel's buffer); a larger box taps the map directly. The
# wrapper reads it at each call; 0 turns the stage off.
STAGE_TEXELS = 8192


class WindowGeometry(NamedTuple):
    """The wrap-padded map the windows lie in: ``pad_y`` / ``pad_x`` rows /
    columns of wrap before the map, ``py_dim`` x ``px_dim`` in all."""

    dim: int
    win: int
    pad_y: int
    pad_x: int
    py_dim: int
    px_dim: int


def window_geometry(dim: int, radius: int, scale: float,
                    win: int) -> WindowGeometry:
    """The JAX wrapper's padding: aligned origins (8 rows / 128 columns)
    exist for every window position; ``win`` is clipped to the map."""
    pad_t = int(math.ceil(scale * radius))
    pad_y = ((pad_t + 7) // 8) * 8
    pad_x = ((pad_t + 127) // 128) * 128
    py_dim = ((dim + pad_y + pad_t + 2 + 7) // 8) * 8
    px_dim = ((dim + pad_x + pad_t + 2 + 127) // 128) * 128
    return WindowGeometry(dim, min(win, dim), pad_y, pad_x, py_dim, px_dim)


def tile_threads(tile_h: int, tile_w: int) -> tuple[int, int]:
    """(threads, pixels a thread) of kernel pcf_window's block for one
    tile: whole warps, at most ``MAX_THREADS`` threads and
    ``PIXELS_A_THREAD`` pixels a thread, as many pixels a thread as fit.
    The tile sums' order follows from it."""
    n = tile_h * tile_w
    for per in range(PIXELS_A_THREAD, 0, -1):
        threads = n // per
        if n % per == 0 and threads % 32 == 0 and 0 < threads <= MAX_THREADS:
            return threads, per
    raise ValueError(
        f"tile {tile_h}x{tile_w}: kernel pcf_window needs tile_h * tile_w "
        f"to be whole warps of 32 threads, at most {MAX_THREADS} threads "
        f"of at most {PIXELS_A_THREAD} pixels")


def _tree(v: torch.Tensor) -> torch.Tensor:
    """The kernel's halving tree (shfl_down 16, 8, 4, 2, 1) over the last
    dimension of 32: lane i adds lane i + off."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def tile_sums_plain(a: torch.Tensor, tile_h: int, tile_w: int):
    """Per-tile sums of an (n_ty * tile_h, n_tx * tile_w) plane in kernel
    pcf_window's order: each thread's pixels in sequence (pixel j of thread
    t is the tile's row-major pixel j * threads + t), then the halving
    tree over a warp's lanes, then over the warps' partials padded with
    zeros to 32. Returns (n_ty, n_tx)."""
    threads, per = tile_threads(tile_h, tile_w)
    n_ty, n_tx = a.shape[0] // tile_h, a.shape[1] // tile_w
    px = a.reshape(n_ty, tile_h, n_tx, tile_w).transpose(1, 2).reshape(
        n_ty, n_tx, per, threads)
    acc = torch.zeros_like(px[..., 0, :])
    for j in range(per):
        acc = acc + px[..., j, :]
    warps = _tree(acc.reshape(n_ty, n_tx, threads // 32, 32))
    return _tree(F.pad(warps, (0, 32 - threads // 32)))


def wrap_window(origin: torch.Tensor, pad: int, offset: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Map index of window offset ``offset`` (0 <= offset < win <= dim) from
    padded ``origin`` (int tensors, broadcast): padded index p holds texel
    (p - pad) mod dim, which is what ``mode="wrap"`` padding holds. The
    kernel's form: the base (origin - pad) mod dim, plus the offset, less
    dim once."""
    t = torch.remainder(origin.long() - pad, dim) + offset
    return torch.where(t >= dim, t - dim, t)


class PcfWindowInputs(NamedTuple):
    """What the taps read, over the frame padded to whole tiles: one
    (wy, wx) origin per tile, and per pixel the padded-space texel
    coordinates, ``z - bias`` and the in-range flag (bool)."""

    geo: WindowGeometry
    origins: torch.Tensor  # (n_ty, n_tx, 2) int32
    fx: torch.Tensor
    fy: torch.Tensor
    zcmp: torch.Tensor
    inrange: torch.Tensor


def pcf_window_inputs(shadow_coord, dim: int, radius: int, scale: float,
                      bias: float, tile_h: int, tile_w: int, win: int,
                      valid: Optional[torch.Tensor] = None):
    """Phase 1 of kernel pcf_window in PyTorch. Rows and columns past the
    last whole tile are zero coordinates that never weigh (the frame's
    padding)."""
    geo = window_geometry(dim, radius, scale, win)
    height, width = shadow_coord.shape[:2]
    ph = -(-height // tile_h) * tile_h
    pw = -(-width // tile_w) * tile_w
    sc = F.pad(shadow_coord, (0, 0, 0, pw - width, 0, ph - height))
    w = sc[..., 3]
    safe_w = torch.where(torch.abs(w) > 1e-20, w, torch.ones_like(w))
    u = sc[..., 0] / safe_w
    v = sc[..., 1] / safe_w
    z = sc[..., 2] / safe_w
    w_post = w / safe_w
    inrange = (z > -1.0) & (z < 1.0) & (w_post > 0.0)
    # The sampler wraps (REPEAT): fold coordinates into [0, dim).
    fx = torch.remainder(u * dim, float(dim))
    fy = torch.remainder(v * dim, float(dim))
    weight = inrange.to(torch.float32)
    if valid is not None:
        weight = weight * F.pad(valid, (0, pw - width, 0, ph - height)).to(
            torch.float32)
    den = tile_sums_plain(weight, tile_h, tile_w)
    count = sc.new_tensor(float(tile_h * tile_w))

    def tile_mean(a):
        num = tile_sums_plain(a * weight, tile_h, tile_w)
        fallback = tile_sums_plain(a, tile_h, tile_w) / count
        return torch.where(den > 0.5, num / torch.clamp_min(den, 1.0),
                           fallback)

    def origin(mean, pad, p_dim, align):
        o = torch.round(mean - geo.win / 2).to(torch.int32) + pad
        o = torch.clamp(o, 0, p_dim - geo.win)
        return torch.div(o, align, rounding_mode="floor") * align

    wy = origin(tile_mean(fy), geo.pad_y, geo.py_dim, 8)
    wx = origin(tile_mean(fx), geo.pad_x, geo.px_dim, 128)
    origins = torch.stack([wy, wx], -1).to(torch.int32)
    return PcfWindowInputs(geo, origins, fx + geo.pad_x, fy + geo.pad_y,
                           z - bias, inrange)


def tap_offsets(radius: int, scale: float) -> list[float]:
    """scale * o for o in [-radius, radius], rounded to f32 as the kernel
    computes it."""
    return [float(np.float32(scale) * np.float32(o))
            for o in range(-radius, radius + 1)]


def pcf_window_tap_index(inp: PcfWindowInputs, off_y: float, off_x: float,
                         tile_h: int, tile_w: int) -> torch.Tensor:
    """Flat index into the unpadded (dim, dim) map of the tap at offsets
    (off_y, off_x) of every pixel: window row floor(fy + off_y) - wy and
    column floor(fx + off_x) - wx, clamped into the window, wrapped by
    ``wrap_window``."""
    geo = inp.geo
    org = inp.origins.repeat_interleave(tile_h, 0).repeat_interleave(
        tile_w, 1).long()
    out = []
    for f, o, pad, k in ((inp.fy, org[..., 0], geo.pad_y, off_y),
                         (inp.fx, org[..., 1], geo.pad_x, off_x)):
        i = torch.clamp(torch.floor(f + k).to(torch.int32) - o, 0,
                        geo.win - 1)
        out.append(wrap_window(o, pad, i, geo.dim))
    return out[0] * geo.dim + out[1]


def compute_pcf_pallas_plain(shadowmap, shadow_coord, radius: int = 2,
                             scale: float = 1.5, bias: float = 0.0,
                             tile_h: int = 32, tile_w: int = 128,
                             win: int = 256,
                             valid: Optional[torch.Tensor] = None,
                             return_origins: bool = False):
    """Plain PyTorch version of kernel ``pcf_window`` (any device)."""
    height, width = shadow_coord.shape[:2]
    inp = pcf_window_inputs(shadow_coord, shadowmap.shape[-1], radius,
                            scale, bias, tile_h, tile_w, win, valid)
    flat = shadowmap.reshape(-1)
    one = torch.ones_like(inp.fx)
    shadowed = one * SHADOW_IN_FACTOR
    total = torch.zeros_like(inp.fx)
    offs = tap_offsets(radius, scale)
    for oy in offs:
        for ox in offs:
            dist = flat[pcf_window_tap_index(inp, oy, ox, tile_h, tile_w)]
            occluded = inp.inrange & (dist < inp.zcmp)
            total = total + torch.where(occluded, shadowed, one)
    out = _tap_mean(total, len(offs) ** 2)[:height, :width]
    return (out, inp.origins) if return_origins else out


def compute_pcf_pallas(shadowmap: torch.Tensor, shadow_coord: torch.Tensor,
                       radius: int = 2, scale: float = 1.5,
                       bias: float = 0.0, tile_h: int = 32,
                       tile_w: int = 128, win: int = 256,
                       valid: Optional[torch.Tensor] = None,
                       backend: str = "auto", return_origins: bool = False):
    """Windowed PCF over an (H, W, 4) homogeneous shadow coordinate: (H, W)
    f32, and with ``return_origins`` the (n_ty, n_tx, 2) int32 window
    origins (wy, wx) in the padded map. H and W need not be multiples of
    the tile: the last tiles read zero coordinates past the frame, as the
    frame's padding did. Tensors on the card go to kernel ``pcf_window``
    (one launch); CPU tensors (or ``backend="torch"``) to
    ``compute_pcf_pallas_plain``. (The TPU entry's ``sub_rows`` sized its
    kernel's inner loop and has no counterpart.)"""
    if not _use_kernel(shadow_coord, backend):
        return compute_pcf_pallas_plain(shadowmap, shadow_coord, radius,
                                        scale, bias, tile_h, tile_w, win,
                                        valid, return_origins)
    dev = shadow_coord.device
    height, width = shadow_coord.shape[:2]
    dim = shadowmap.shape[-1]
    if shadowmap.shape != (dim, dim) or dim * dim >= 2 ** 31:
        raise ValueError(f"shadowmap: expected a square map under 2^31 "
                         f"texels, got {tuple(shadowmap.shape)}")
    threads, per = tile_threads(tile_h, tile_w)
    geo = window_geometry(dim, radius, scale, win)
    ptrs = [_check(shadowmap, "shadowmap", torch.float32, dev=dev),
            _check(shadow_coord, "shadow_coord", torch.float32,
                   (height, width, 4), dev)]
    ptrs.append(None if valid is None else _check(
        valid, "valid", torch.bool, (height, width), dev))
    if not 0 <= STAGE_TEXELS <= 8192:
        raise ValueError(f"STAGE_TEXELS {STAGE_TEXELS} outside [0, 8192]")
    out = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_ty, n_tx = -(-height // tile_h), -(-width // tile_w)
    origins = torch.empty((n_ty, n_tx, 2), dtype=torch.int32,
                          device=dev) if return_origins else None
    with torch.cuda.device(dev):
        code = _build.load().zk_pcf_window(
            ptrs[0], dim, ptrs[1], ptrs[2], out.data_ptr(),
            None if origins is None else origins.data_ptr(), height, width,
            tile_h, tile_w, threads, per, geo.win, geo.pad_y, geo.pad_x,
            geo.py_dim, geo.px_dim, int(radius), float(scale), float(bias),
            STAGE_TEXELS, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pcf_window")
    compute_pcf_pallas.launches += 1
    return (out, origins) if return_origins else out


compute_pcf_pallas.launches = 0
