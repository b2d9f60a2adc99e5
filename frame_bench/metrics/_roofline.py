"""The work of the two raster kernels, counted from the frame's triangles.

Kernel ``pair_raster`` (K1, the shadow map) and ``pair_raster_fused``
(K2, the GBuffer) are held against the least time the card could take
for their pass: the larger of its bytes over 3.35 TB/s and its fp32
operations over 67 TFLOP/s (NVIDIA H100 SXM data sheet, an FMA counted as
two operations). Both counts come from the triangles the pass rasters and
from nothing of how the program bins them (tiles, pair expansion, sub-rows,
record layout), so the same frame gives the same bound whatever rasters
it:

- operations: ``OPS_PER_TEST`` per pixel centre inside each rastered
  triangle's bounding box, clipped to the pass's buffer;
- bytes: each rastered triangle's setup row read once, and the pass's
  output planes written once.

A rastered triangle is one the pass's setup keeps (``valid``) whose box
holds at least one pixel centre.
"""

from __future__ import annotations

import torch

# Operations of one (pixel, triangle) coverage test, copied from
# zeldaengine_tpu_torch/tools/walk_stats.py at commit fcd25b5: three edge
# functions (2 mul + 2 add each), depth (3 mul + 2 add), edge sum (2),
# edge min (2), five compares and the select.
OPS_PER_TEST = 26
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
WORD = 4
# A setup row: three edge functions (9 words) and the depth plane (3).
RASTER_ROW_WORDS = 12
# The GBuffer pass's attributes: a material combo id and, at each corner,
# uv (2), colour (3), world position (3) and world normal (3).
GBUFFER_ATTR_WORDS = 1 + 3 * 11
# Output planes: the shadow map's depth; the GBuffer's depth, triangle id
# and 24 attribute planes.
SHADOW_OUT_WORDS = 1
GBUFFER_OUT_WORDS = 2 + 24

PASSES = {
    "shadow": (RASTER_ROW_WORDS, SHADOW_OUT_WORDS),
    "gbuffer": (RASTER_ROW_WORDS + GBUFFER_ATTR_WORDS, GBUFFER_OUT_WORDS),
}


def centres_in_boxes(bbox: torch.Tensor, width: int,
                     height: int) -> torch.Tensor:
    """Pixel centres (i + 0.5, j + 0.5) inside each (x0, y0, x1, y1) box,
    clipped to a ``width`` x ``height`` buffer: (T,) int64."""
    b = bbox.to(torch.float64)

    def span(lo, hi, n):
        first = torch.clamp(torch.ceil(lo - 0.5), min=0)
        last = torch.clamp(torch.floor(hi - 0.5), max=n - 1)
        return torch.clamp(last - first + 1, min=0)

    return (span(b[:, 0], b[:, 2], width)
            * span(b[:, 1], b[:, 3], height)).to(torch.int64)


def pass_work(valid: torch.Tensor, bbox: torch.Tensor, width: int,
              height: int, name: str) -> dict:
    """(operations, bytes) of one raster pass over these triangles."""
    row_words, out_words = PASSES[name]
    tests = centres_in_boxes(bbox, width, height)
    tests = torch.where(valid, tests, torch.zeros_like(tests))
    rastered = int((tests > 0).sum())
    n_tests = int(tests.sum())
    return dict(tests=n_tests, triangles=rastered,
                ops=n_tests * OPS_PER_TEST,
                bytes=(rastered * row_words + width * height * out_words)
                * WORD)


def bound_s(work: dict) -> float:
    return max(work["bytes"] / PEAK_BYTES_PER_S,
               work["ops"] / PEAK_FP32_PER_S)


def share_pct(run, pass_name: str):
    """A kernel's share of its roofline over the traced frames whose work
    the run counted: the sum of their bounds over the sum of the kernel's
    device time in those frames, in percent; None where nothing was
    counted or the kernel did not run."""
    frames = run.roofline_frames.get(pass_name) or []
    bound = sum(f["bound_s"] for f in frames)
    took = sum(f["kernel_s"] for f in frames)
    if not frames or took <= 0.0:
        return None
    return 100.0 * bound / took
