"""The strip walk of kernels ``pair_raster`` and ``pair_raster_fused``
(``strip_walk_hits`` / ``strip_walk_tests``) skips only pairs that cover
nothing of a warp's pixels inside their bbox, on random triangles and on
the golden scene's shadow pass."""

import functools

import numpy as np
import pytest
import torch

from zeldaengine_tpu_torch.ops import rasterize as tr
from zeldaengine_tpu_torch.ops import rasterize_cuda as tp

from _torch_raster_inputs import random_clip as _random_clip

torch.set_num_threads(1)


def _golden_shadow_pairs():
    """The golden scene's shadow pass as its CPU frame builds it: (setup,
    pairs, rasterize_pairs keywords)."""
    from zeldaengine_tpu_torch import TEST_CONFIG
    from zeldaengine_tpu_torch.passes import frame as frame_graph
    from zeldaengine_tpu_torch.scene.demo import build_golden_scene

    scene, meta, view = build_golden_scene(TEST_CONFIG, device="cpu")
    noted = {}
    build, raster = frame_graph.build_pairs, frame_graph.rasterize_pairs

    def note_build(setup, *a, **k):
        out = build(setup, *a, **k)
        noted.setdefault("pairs", (setup, out))
        return out

    def note_raster(*a, **k):
        noted.setdefault("kw", k)
        return raster(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(frame_graph, "build_pairs", note_build)
    mp.setattr(frame_graph, "rasterize_pairs", note_raster)
    try:
        frame_graph.render_frame(scene, view, meta, TEST_CONFIG)
    finally:
        mp.undo()
    return (*noted["pairs"], noted["kw"])


@pytest.mark.parametrize("height,width,tile_h,tile_w,shadow", [
    pytest.param(72, 96, 24, 32, False, id="72-96-24-32"),
    pytest.param(64, 128, 64, 32, False, id="64-128-64-32"),
    pytest.param(64, 128, 8, 128, False, id="64-128-8-128"),
    pytest.param(72, 96, 24, 24, False, id="72-96-24-24"),
    pytest.param(64, 128, 64, 32, True, id="shadow-64-128-64-32"),
    pytest.param(256, 256, 8, 128, "golden", id="golden-shadow-pass")])
def test_strip_walk_skips_only_pairs_that_cover_nothing(height, width,
                                                        tile_h, tile_w,
                                                        shadow):
    """``strip_walk_hits`` / ``strip_walk_tests`` model what the strip walk of
    kernels ``pair_raster_fused`` and ``pair_raster`` tests. A warp skips a
    pair only where the pair covers none of the warp's pixels inside the
    triangle's bbox. Outside its bbox a sliver whose edge values all lie within
    rounding of zero can pass the fused-form coverage test and still be
    skipped. So the skip is exact only inside the bbox, and the plain pair
    versions apply the same skip rule when given a span column (``y_row`` >=
    0). On the random triangles and the golden shadow pass here, no covered
    pixel is skipped at all. Without a span column, every warp that owns pixels
    tests every pair against all of its 32 * NPP slots. ``shadow``: the shadow
    map's records (no payload, 16 columns, the span in column 13), as kernel
    ``pair_raster`` gets them; "golden": the golden scene's shadow pass as its
    frame builds it."""
    if shadow == "golden":
        ts, pairs, kw = _golden_shadow_pairs()
        assert (kw["tile_h"], kw["tile_w"]) == (tile_h, tile_w)
        assert pairs.records.shape[1] == 16 and kw["y_row"] == 13
        y_row = kw["y_row"]
    else:
        clip = _random_clip(21, n=300)
        clip[5, 0, 3] = -0.5  # crosses the camera plane: full-screen bbox
        ts = tr.triangle_setup(torch.from_numpy(clip), width, height,
                               two_sided=True)
        n_extra = 0 if shadow else tp.fused_extra_width(need_uv=False,
                                                        need_combo=False)
        extra = None if shadow else torch.from_numpy(
            np.random.default_rng(4).random((300, n_extra)).astype(
                np.float32))
        pairs = tp.build_pairs(ts, width, height, tile_h, tile_w, expand=4,
                               extra=extra, sort_z=True, ysort_sub_rows=8)
        y_row = 12 + n_extra + 1  # after the payload and the z column
        if shadow:
            assert pairs.records.shape[1] == 16 and y_row == 13
    tiles, pids, hit = tp.strip_walk_hits(pairs, height, width, tile_h,
                                          tile_w, 8, y_row)
    # Coverage of every (tile, pair) entry at every pixel of the tile, by
    # the plain version's arithmetic, folded onto the 8 warps: all of it,
    # and only at pixel centres inside the triangle's bbox.
    n_tx = width // tile_w
    run = 32 * tp._pixels_per_thread(tile_h, tile_w)
    loc = torch.arange(tile_h * tile_w)
    gx = (tiles % n_tx)[:, None] * tile_w + loc % tile_w
    gy = (tiles // n_tx)[:, None] * tile_h + loc // tile_w
    px, py = gx.float() + 0.5, gy.float() + 0.5
    r = pairs.records[pids]
    e = [tr.edge_value(r[:, 3 * i : 3 * i + 1], r[:, 3 * i + 1 : 3 * i + 2],
                       r[:, 3 * i + 2 : 3 * i + 3], px, py) for i in range(3)]
    d = tr.plane_depth(*e, r[:, 9:10], r[:, 10:11], r[:, 11:12])
    inside = ((torch.minimum(torch.minimum(e[0], e[1]), e[2]) >= 0)
              & (e[0] + e[1] + e[2] > 0) & (d >= 0) & (d <= 1))
    bb = ts.bbox[pairs.pair_tri.long()[pids]]
    in_bbox = ((px >= bb[:, 0:1]) & (px <= bb[:, 2:3])
               & (py >= bb[:, 1:2]) & (py <= bb[:, 3:4]))
    warps = (torch.arange(tiles.shape[0])[:, None].expand_as(inside),
             (loc // run)[None, :].expand_as(inside))

    def fold(mask):
        return torch.zeros_like(hit).index_put_(warps, mask, accumulate=True)

    covers = fold(inside)
    # Most of the golden shadow map's triangles are small: a quarter of
    # their (tile, pair) entries cover a pixel of the tile (measured 0.24).
    assert covers.any(1).float().mean() > (0.2 if shadow == "golden"
                                           else 0.3)
    assert not (fold(inside & in_bbox) & ~hit).any()
    assert not (covers & ~hit).any()
    skipped = tp.strip_walk_tests(pairs, height, width, tile_h, tile_w, 8,
                                  y_row)
    assert int(skipped.sum()) == int(hit.sum()) * run
    full = tp.strip_walk_tests(pairs, height, width, tile_h, tile_w)
    owning = -(-(tile_h * tile_w) // run)
    assert int(full.sum()) == tiles.shape[0] * owning * run
    assert int(skipped.sum()) < int(full.sum())
    # The wrapper names the span column and the strip height it is given.
    raster = tp.rasterize_pairs if shadow else functools.partial(
        tp.rasterize_pairs_fused, need_uv=False, has_combo=False)
    with pytest.raises(ValueError, match="not a column"):
        raster(pairs, height, width, tile_h=tile_h, tile_w=tile_w,
               y_row=pairs.records.shape[1])
    with pytest.raises(ValueError, match="sub_rows"):
        raster(pairs, height, width, tile_h=tile_h, tile_w=tile_w,
               sub_rows=0, y_row=y_row)
