"""The 25-tap PCF shadow filter as a CUDA kernel.

Reference semantics: ComputePCF, Common.glsl:323-342, through the plain
version ``compute_pcf_plain`` (= ``ops/shadow.py::compute_pcf``). Kernel
``pcf_taps`` (``csrc/pcf_taps.cu``) replaces the JAX package's
``ops/pcf_vmem.py::compute_pcf_vmem``: one thread per pixel loads its
taps straight from the shadow map, so the window-fit test, the slab rolls
and the unfit-block recompute of that kernel have no counterpart here and
``overflow`` is the constant 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from zeldaengine_tpu_torch.ops import _build
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel
from zeldaengine_tpu_torch.ops.shadow import compute_pcf

compute_pcf_plain = compute_pcf


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
    h, w = shadow_coord.shape[:2]
    sm_ptr = _check(shadowmap, "shadowmap", torch.float32, dev=dev)
    sc_ptr = _check(shadow_coord, "shadow_coord", torch.float32, dev=dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _build.load().zk_pcf_taps(
            sm_ptr, shadowmap.shape[0], shadowmap.shape[1], sc_ptr,
            out.data_ptr(), h * w, int(radius), float(scale), float(bias),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "pcf_taps")
    compute_pcf_vmem.launches += 1
    return out, 0


compute_pcf_vmem.launches = 0
