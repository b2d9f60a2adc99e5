"""Mip-0 bilinear tap of an image plane stack: the skydome's texture tap.

The skydome equirect (and the background rect) are sampled once per pixel
at mip 0 with smooth screen-space uv. Kernel ``bilinear_tap``
(``csrc/bilinear_tap.cu``) replaces the JAX package's
``ops/window_tap.py::sample_base_window``: one thread per pixel loads its
four texels directly, so that kernel's per-block window, fit test and
unfit-block recompute have no counterpart here and ``overflow`` is the
constant 0.

Same addressing as ``sample_base`` on the quad-packed atlas of the same
(bf16-stored) image: repeat wrap of the uv, ``x1 = min(x0 + 1, S - 1)``
edge clamp exactly like ``build_packed_mip_atlas``'s neighborhood, same
lerp order. ``torch.nn.functional.grid_sample`` is NOT the same function:
its wrap modes reflect or clamp where this one repeats the uv and then
clamps at the texture edge.
"""

from __future__ import annotations

from typing import Optional

import torch

from zeldaengine_tpu_torch.ops import _build
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel


def _coords(uv, size: int):
    """sample_bilinear_level_packed's mip-0 index math, verbatim."""
    size_f = float(size)
    uw = uv[..., 0] - torch.floor(uv[..., 0])
    vw = uv[..., 1] - torch.floor(uv[..., 1])
    u = uw * size_f - 0.5
    v = vw * size_f - 0.5
    x0 = torch.clamp(torch.floor(u).to(torch.int32), 0, size - 1)
    y0 = torch.clamp(torch.floor(v).to(torch.int32), 0, size - 1)
    fu = torch.clamp(u - x0.to(torch.float32), 0.0, 1.0)
    fv = torch.clamp(v - y0.to(torch.float32), 0.0, 1.0)
    return x0, y0, fu, fv


def sample_base_window_plain(planes: torch.Tensor, uv: torch.Tensor,
                             active: Optional[torch.Tensor], size: int):
    """Plain PyTorch version of ``sample_base_window`` (any device)."""
    c = planes.shape[0]
    x0, y0, fu, fv = _coords(uv, size)
    flat = planes.reshape(c, -1)
    x1 = torch.clamp_max(x0 + 1, size - 1)
    y1 = torch.clamp_max(y0 + 1, size - 1)

    def g(yy, xx):
        return flat[:, (yy * size + xx).long()]  # (C, H, W)

    t00, t10, t01, t11 = g(y0, x0), g(y0, x1), g(y1, x0), g(y1, x1)
    top = t00 * (1 - fu) + t10 * fu
    bot = t01 * (1 - fu) + t11 * fu
    out = torch.movedim(top * (1 - fv) + bot * fv, 0, -1)
    if active is not None:
        out = torch.where(active[..., None], out, torch.zeros_like(out))
    return out


def sample_base_window(planes: torch.Tensor, uv: torch.Tensor,
                       active: Optional[torch.Tensor], size: int,
                       backend: str = "auto"):
    """Bilinear mip-0 tap of (C, S, S) f32 planes at uv (H, W, 2).

    Returns ((H, W, C) f32, overflow). Exact vs ``sample_base`` on the
    quad atlas built from the same image at every active pixel; pixels
    outside ``active`` are 0. Tensors on the card go to kernel
    ``bilinear_tap``; CPU tensors (or ``backend="torch"``) to
    ``sample_base_window_plain``.
    """
    c, s, s2 = planes.shape
    assert s == s2 == size, (planes.shape, size)
    if not _use_kernel(uv, backend):
        return sample_base_window_plain(planes, uv, active, size), 0
    dev = uv.device
    if uv.ndim != 3 or uv.shape[-1] != 2:
        raise ValueError(f"uv: expected (H, W, 2), got {tuple(uv.shape)}")
    h, w = uv.shape[:2]
    p_ptr = _check(planes, "planes", torch.float32, dev=dev)
    uv_ptr = _check(uv, "uv", torch.float32, dev=dev)
    act_ptr = None if active is None else _check(
        active, "active", torch.bool, (h, w), dev)
    out = torch.empty((h, w, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _build.load().zk_bilinear_tap(
            p_ptr, c, size, uv_ptr, act_ptr, out.data_ptr(), h * w,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "bilinear_tap")
    sample_base_window.launches += 1
    return out, 0


sample_base_window.launches = 0


def planes_from_image_bf16(image) -> torch.Tensor:
    """(S, S, C) image -> (C, S, S) f32 planes holding the bf16-rounded
    values the quad atlas stores (so the kernel's taps are bitwise-equal
    to sample_base on that atlas)."""
    img = torch.as_tensor(image).to(torch.bfloat16).to(torch.float32)
    return torch.movedim(img, -1, 0).contiguous()
