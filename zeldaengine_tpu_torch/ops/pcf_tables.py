"""Shadow-map window tables for the table-driven PCF backends.

Kernel ``pcf_window_table`` replaces the JAX package's
``ops/pcf_pallas.py::_window_table_kernel`` (entry
``build_pcf_window_table``): the 8-wide x-window of every texel,
``out[y * D + x, c] = sm[y, (x + lo + c) mod D]``, that
``compute_pcf_packed_roll`` gathers one tap row from. Kernel
``pcf_window2d_table`` replaces ``_window2d_table_kernel`` (entry
``build_pcf_window2d_table``): the whole (w_y x 8) window,
``out[y * D + x, dy * 8 + dx] = sm[(y + lo_y + dy) mod D, (x + lo_x + dx)
mod D]``, that ``compute_pcf_window_roll`` gathers all taps from at once.
Both are pure data movement, one CUDA source (``csrc/pcf_window_table.cu``):
the TPU builds them with lane rolls and an in-kernel transpose. Here K7
stages each map row's wrapped texels in shared memory once and writes the
row's table as consecutive 16-byte groups; K8 has every thread write one
16-byte group of a table row straight from the map.
"""

from __future__ import annotations

import torch

from zeldaengine_tpu_torch.ops import _build
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel

N_X = 8  # x taps per table row group (the TPU table's padded width)


def _wrapped(n: int, lo: int, width: int, device) -> torch.Tensor:
    """(n, width) indices (i + lo + c) mod n."""
    i = torch.arange(n, device=device)[:, None]
    c = torch.arange(width, device=device)[None, :]
    return torch.remainder(i + lo + c, n)


def build_pcf_window2d_table_plain(shadowmap: torch.Tensor, lo_x: int = -3,
                                   lo_y: int = -3, w_y: int = 7):
    """Plain PyTorch version of kernel ``pcf_window2d_table``."""
    d_y, d_x = shadowmap.shape
    rows = _wrapped(d_y, lo_y, w_y, shadowmap.device)  # (D_y, w_y)
    cols = _wrapped(d_x, lo_x, N_X, shadowmap.device)  # (D_x, 8)
    out = shadowmap[rows[:, None, :, None], cols[None, :, None, :]]
    return out.reshape(d_y * d_x, w_y * N_X)


def build_pcf_window_table_plain(shadowmap: torch.Tensor, lo: int = -3,
                                 hi: int = 3):
    """Plain PyTorch version of kernel ``pcf_window_table``."""
    assert hi - lo + 1 <= N_X, "window wider than the padded 8 channels"
    return build_pcf_window2d_table_plain(shadowmap, lo_x=lo, lo_y=0, w_y=1)


def _launch(name: str, shadowmap, lo_x: int, lo_y: int, w_y: int):
    dev = shadowmap.device
    if shadowmap.ndim != 2:
        raise ValueError(f"shadowmap: expected (D_y, D_x), got "
                         f"{tuple(shadowmap.shape)}")
    d_y, d_x = shadowmap.shape
    sm_ptr = _check(shadowmap, "shadowmap", torch.float32, dev=dev)
    out = torch.empty((d_y * d_x, w_y * N_X), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        fn = getattr(_build.load(), "zk_" + name)
        code = fn(sm_ptr, d_y, d_x, lo_x, lo_y, w_y, out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    return out


def build_pcf_window_table(shadowmap: torch.Tensor, lo: int = -3,
                           hi: int = 3, backend: str = "auto"):
    """(D_y * D_x, 8) f32: row (y * D_x + x) holds sm[y, (x + lo .. x + lo
    + 7) mod D_x], a superset of the (lo .. hi) window. Tensors on the
    card go to kernel ``pcf_window_table``; CPU tensors (or
    ``backend="torch"``) to ``build_pcf_window_table_plain``."""
    assert hi - lo + 1 <= N_X, "window wider than the padded 8 channels"
    if not _use_kernel(shadowmap, backend):
        return build_pcf_window_table_plain(shadowmap, lo=lo, hi=hi)
    out = _launch("pcf_window_table", shadowmap, lo, 0, 1)
    build_pcf_window_table.launches += 1
    return out


def build_pcf_window2d_table(shadowmap: torch.Tensor, lo_x: int = -3,
                             lo_y: int = -3, w_y: int = 7,
                             backend: str = "auto"):
    """(D_y * D_x, w_y * 8) f32: the (w_y x 8) window of every texel, one
    table row each. Tensors on the card go to kernel
    ``pcf_window2d_table``; CPU tensors (or ``backend="torch"``) to
    ``build_pcf_window2d_table_plain``."""
    if not _use_kernel(shadowmap, backend):
        return build_pcf_window2d_table_plain(shadowmap, lo_x=lo_x,
                                              lo_y=lo_y, w_y=w_y)
    out = _launch("pcf_window2d_table", shadowmap, lo_x, lo_y, w_y)
    build_pcf_window2d_table.launches += 1
    return out


build_pcf_window_table.launches = 0
build_pcf_window2d_table.launches = 0
