"""The property that makes the strip walk's skip exact (kernels
``pair_raster_fused`` and ``pair_raster``): every pixel the plain version
covers lies inside the packed strip span of its winning pair, on the pair
streams the frame builds. The scene and view are test_torch_fused.py's
(the module fixture of both files, ``_torch_fused_state.py``)."""

import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops.rasterize import triangle_setup as j_triangle_setup
from zeldaengine_tpu.passes import frame as jframe
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import setup_from_numpy
from zeldaengine_tpu_torch.ops import rasterize_cuda as tp
from zeldaengine_tpu_torch.passes import frame as tframe

from _torch_compare import to_numpy_leaves
from _torch_fused_state import W, fused_state

torch.set_num_threads(1)

state = pytest.fixture(scope="module")(fused_state)


@pytest.mark.parametrize("tile_h,tile_w,height,shadow", [
    pytest.param(8, 128, 128, False, id="8-128-128"),
    pytest.param(16, 32, 128, False, id="16-32-128"),
    pytest.param(24, 32, 120, False, id="24-32-120"),
    pytest.param(64, 32, 120, False, id="64-32-120"),
    pytest.param(64, 32, 120, True, id="shadow-64-32-120")])
def test_covered_pixels_lie_in_their_winners_strip_span(state, tile_h,
                                                        tile_w, height,
                                                        shadow):
    """Every pixel the plain version covers lies inside the packed strip
    span of its winning pair, on the pair stream the frame builds; the
    frame pads 120 rows to 128 for 64-row tiles, and the span reaches the
    padded rows too. This is what makes the kernels' skip exact.
    ``shadow``: the shadow map's pairs (``_raster_depth``, a 120^2 map on
    64x32 shadow tiles) and kernel ``pair_raster``'s wrapper."""
    cfg, scene, view, world, n_world, _, clip = state
    width = height if shadow else W
    jsetup = j_triangle_setup(
        clip[scene.tri_vtx], width, height, two_sided=scene.tri_two_sided,
        valid_mask=scene.tri_valid & scene.tri_deferred)
    setup = setup_from_numpy(to_numpy_leaves(jsetup), "cpu")
    if shadow:
        tcfg = TEST_CONFIG.replace(shadow_tile_h=tile_h, shadow_tile_w=tile_w)
        _, pairs, _ = tframe._raster_depth(setup, height, tcfg)
        ph = pw = -(-height // tile_h) * tile_h
        y_row = 13
        _, tid = tp.rasterize_pairs(pairs, ph, pw, tile_h=tile_h,
                                    tile_w=tile_w, sub_rows=8, y_row=y_row)
    else:
        extra = jframe._fused_extra(scene, jsetup, world, n_world)
        tcfg = TEST_CONFIG.replace(width=W, height=height, tile_h=tile_h,
                                   tile_w=tile_w)
        _, _, _, pairs, _ = tframe._raster_vis_fused(
            setup, torch.from_numpy(np.array(extra)), height, W, tcfg)
        ph, pw = -(-height // tile_h) * tile_h, W
        y_row = 12 + extra.shape[1] + 1
        _, tid, _ = tp.rasterize_pairs_fused(
            pairs, ph, pw, tile_h=tile_h, tile_w=tile_w, sub_rows=8,
            y_row=y_row)
    span = torch.zeros(setup.edge.shape[0] + 1)  # + the dead row
    span[pairs.pair_tri.long()] = pairs.records[:, y_row]
    cov = tid >= 0
    rows = torch.arange(ph)[:, None].expand(ph, pw)[cov].float()
    v = span[tid[cov].long()]
    ysub1 = torch.floor(v / 4096.0)
    ysub0 = v - ysub1 * 4096.0
    assert cov.float().mean() > 0.3
    if ph > height:
        assert cov[height:].any()
    assert bool(((ysub0 * 8 <= rows) & (rows <= (ysub1 + 1) * 8 - 1)).all())
