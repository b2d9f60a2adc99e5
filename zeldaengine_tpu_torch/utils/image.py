"""PNG I/O (replaces stb_image load; the renderer's presentation path is
an offscreen PNG/array). Pillow is imported inside the functions: nothing
on the render path needs it."""

from __future__ import annotations

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0,1] (H,W,3|4) -> uint8."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(to_uint8(img)).save(path)


def read_png(path: str, size: int | None = None) -> np.ndarray:
    """Load a PNG to float32 RGBA in [0,1]; optionally resize to square
    ``size`` (bilinear), matching the engine's texture-pool normalization."""
    from PIL import Image

    im = Image.open(path).convert("RGBA")
    if size is not None and im.size != (size, size):
        im = im.resize((size, size), Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0
