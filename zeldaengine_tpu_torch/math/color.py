"""Color helpers shared by shaders (Common.glsl ports)."""

from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32))


def hue2rgb(hue):
    """Common.glsl:50-58 Hue2RGB; vectorized over any leading shape.

    Returns (..., 3) rgb in [0,1].
    """
    hue = _f32(hue)
    h = hue - torch.floor(hue)  # fract
    r = torch.abs(h * 6.0 - 3.0) - 1.0
    g = 2.0 - torch.abs(h * 6.0 - 2.0)
    b = 2.0 - torch.abs(h * 6.0 - 4.0)
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


def gamma_correct(color):
    """``pow(c, 0.4545)`` as used at the end of every fragment shader
    (Base.frag:117, BaseLighting.frag:232, Skydome.frag:16)."""
    return torch.pow(torch.clamp_min(color, 0.0), 0.4545)


def srgb_to_linear(color):
    """sRGB decode used for basecolor textures; the reference relies on
    VK_FORMAT_R8G8B8A8_SRGB hardware decode for basecolor only
    (ZeldaEngine.cpp:4868). Uses the exact piecewise sRGB EOTF."""
    c = _f32(color)
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))
