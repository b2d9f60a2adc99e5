"""The rooflines' work comes from the triangles: the count is the same
whatever the tiles, the pair expansion or the sub-rows, where a count from
the pair lists is not."""

import numpy as np
import pytest
import torch

from frame_bench.metrics import _roofline
from frame_bench.reference import raster
from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.ops.rasterize import triangle_setup
from zeldaengine_tpu_torch.ops.rasterize_cuda import build_pairs

W, H = 256, 128


def _clip(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    centre = rng.uniform([-1.0, -1.0, 0.2], [1.0, 1.0, 0.8], (n, 1, 3))
    size = rng.choice([0.004, 0.05, 0.6], (n, 1, 1))
    xyz = centre + rng.uniform(-1.0, 1.0, (n, 3, 3)) * size
    return torch.from_numpy(
        np.concatenate([xyz, np.ones((n, 3, 1))], -1).astype(np.float32))


def _setup(seed: int):
    """The reference's setup of the triangles, whose work the rooflines
    count."""
    return raster.setup(_clip(seed), W, H, two_sided=True)


def _work(setup):
    return _roofline.pass_work(setup.valid, setup.bbox, W, H, "gbuffer")


def test_centres_in_boxes_matches_a_brute_count():
    rng = np.random.default_rng(3)
    boxes = np.sort(rng.uniform(-5, 70, (300, 2, 2)), axis=1)
    bbox = torch.from_numpy(np.stack(
        [boxes[:, 0, 0], boxes[:, 0, 1], boxes[:, 1, 0], boxes[:, 1, 1]],
        -1).astype(np.float32))
    got = _roofline.centres_in_boxes(bbox, 64, 48)
    px = np.arange(64) + 0.5
    py = np.arange(48) + 0.5
    b = bbox.numpy().astype(np.float64)
    want = [((px >= x0) & (px <= x1)).sum() * ((py >= y0) & (py <= y1)).sum()
            for x0, y0, x1, y1 in b]
    assert got.tolist() == want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_work_does_not_follow_the_binning(seed):
    setup = _setup(seed)
    work = _work(setup)
    assert work["tests"] > 0 and work["triangles"] > 0
    # The program's binning of the same triangles.
    binned = triangle_setup(_clip(seed), W, H, two_sided=True)
    live = set()
    for tile_h, tile_w, expand, sub_rows in [(8, 128, 8, 8), (32, 128, 4, 8),
                                             (64, 32, 8, 4), (16, 64, 2, 2)]:
        cfg = EngineConfig(width=W, height=H, tile_h=tile_h, tile_w=tile_w,
                           pair_expand=expand, sub_rows=sub_rows)
        pairs = build_pairs(binned, W, H, cfg.tile_h, cfg.tile_w,
                            expand=cfg.pair_expand,
                            ysort_sub_rows=cfg.sub_rows)
        live.add(int(pairs.gbounds[1]) * pairs.records.shape[1])
        assert _work(setup) == work
    # A count of pair records (the byte term of the old bound) moves with
    # the binning; the triangles' count above does not.
    assert len(live) > 1


def test_bound_is_the_larger_term():
    w = dict(ops=67e12, bytes=1.0)
    assert _roofline.bound_s(w) == pytest.approx(1.0)
    w = dict(ops=1.0, bytes=3.35e12 * 2)
    assert _roofline.bound_s(w) == pytest.approx(2.0)


def test_share_reads_nothing_without_frames():
    class R:
        roofline_frames = {}
    assert _roofline.share_pct(R, "gbuffer") is None
    R.roofline_frames = {"gbuffer": [dict(bound_s=1e-5, kernel_s=1e-4)]}
    assert _roofline.share_pct(R, "gbuffer") == pytest.approx(10.0)
