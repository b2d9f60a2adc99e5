"""The 25-tap PCF shadow filter as a CUDA kernel.

Reference semantics: ComputePCF, Common.glsl:323-342, through the plain
version ``compute_pcf_plain`` (= ``ops/shadow.py::compute_pcf``). Kernel
``pcf_taps`` (``csrc/pcf_taps.cu``) replaces the JAX package's
``ops/pcf_vmem.py::compute_pcf_vmem``. At the frame's radius (2) a block
of 32x16 pixels copies the box of map texels its taps reach into shared
memory and taps there; a block whose box does not fit, and every other
radius, taps the map directly. Every pixel is computed, so the JAX
kernel's slab rolls and unfit-block recompute have no counterpart and
``overflow`` is the constant 0. The kernel wraps each axis's tap indices
without a division per tap; ``wrap_tap_indices`` is that rule in PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from zeldaengine_tpu_torch.ops import _build
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel
from zeldaengine_tpu_torch.ops.shadow import compute_pcf

compute_pcf_plain = compute_pcf


def wrap_tap_indices(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel ``pcf_taps``'s repeat addressing of one axis: ``idx`` (..., K)
    int32 holds the K = 2r+1 texel indices floor(f + scale*o) of a pixel,
    and the result is each wrapped into [0, n), as ``torch.remainder(idx,
    n)`` would give. Only the first index takes a remainder; index k is
    wrap(i_0) + (i_k - i_0) in 64-bit integers, less n once, and only an
    index more than one map width past (a map narrower than the footprint)
    or before it takes the remainder. Exact for any int32 input."""
    i = idx.to(torch.int64)
    w0 = torch.remainder(i[..., :1], n)
    t = w0 + (i - i[..., :1])
    t = torch.where(t >= n, t - n, t)
    t = torch.where((t >= n) | (t < 0), torch.remainder(t, n), t)
    return t.to(torch.int32)


def compute_pcf_vmem(shadowmap: torch.Tensor, shadow_coord: torch.Tensor,
                     radius: int = 2, scale: float = 1.5, bias: float = 0.0,
                     active: Optional[torch.Tensor] = None,
                     backend: str = "auto"):
    """ComputePCF over an (H, W, 4) homogeneous shadow coordinate.

    Returns ``(factor (H, W) f32, overflow)``; out-of-range pixels read
    1.0. ``active`` only ever gated the JAX kernel's window-fit test, never
    its output: it is accepted and every in-range pixel is computed all
    the same. Tensors on the card go to kernel ``pcf_taps``; CPU tensors
    (or ``backend="torch"``) to ``compute_pcf_plain``.
    """
    del active
    if not _use_kernel(shadow_coord, backend):
        return compute_pcf_plain(shadowmap, shadow_coord, radius=radius,
                                 scale=scale, bias=bias), 0
    dev = shadow_coord.device
    if shadowmap.ndim != 2:
        raise ValueError(f"shadowmap: expected (D, D), got "
                         f"{tuple(shadowmap.shape)}")
    if shadow_coord.ndim != 3 or shadow_coord.shape[-1] != 4:
        raise ValueError(f"shadow_coord: expected (H, W, 4), got "
                         f"{tuple(shadow_coord.shape)}")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    h, w = shadow_coord.shape[:2]
    sm_ptr = _check(shadowmap, "shadowmap", torch.float32, dev=dev)
    sc_ptr = _check(shadow_coord, "shadow_coord", torch.float32, dev=dev)
    if sc_ptr % 16:
        raise ValueError("shadow_coord: the kernel loads each coordinate as "
                         "one float4; needs a 16-byte aligned base")
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _build.load().zk_pcf_taps(
            sm_ptr, shadowmap.shape[0], shadowmap.shape[1], sc_ptr,
            out.data_ptr(), h, w, int(radius), float(scale), float(bias),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pcf_taps")
    compute_pcf_vmem.launches += 1
    return out, 0


compute_pcf_vmem.launches = 0
