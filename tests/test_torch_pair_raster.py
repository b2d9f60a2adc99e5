"""The plain version of kernel ``pair_raster`` against the Pallas kernel in
interpret mode and against the port's brute-force rasterizer, the winner
rule at exact ties, and the wrappers' device rule. The CUDA kernel itself
is held against this plain version on the card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.ops import rasterize_pallas as jp
from zeldaengine_tpu_torch.convert import pairs_from_numpy, setup_from_numpy
from zeldaengine_tpu_torch.ops import rasterize as tr
from zeldaengine_tpu_torch.ops import rasterize_cuda as tp

from _torch_compare import to_numpy_leaves
from _torch_raster_inputs import (
    H, W, random_clip as _random_clip, setups as _setups)

torch.set_num_threads(1)


def test_build_pairs_accepts_gather_layouts_and_refuses_align():
    _, ts = _setups(5)
    a = tp.build_pairs(ts, W, H, 8, 128)
    b = tp.build_pairs(ts, W, H, 8, 128, gather_chunks=4, gather_pack=8)
    np.testing.assert_array_equal(a.records.numpy(), b.records.numpy())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp.build_pairs(ts, W, H, 8, 128, align=True)


def _off_ties(depth_ref, tid_a, tid_b):
    """Triangle ids are compared where they can be: the TPU kernel
    quantises its winner key (2^-16 depth levels), so near-ties may
    resolve to another triangle; fewer than 1 % of pixels, as the JAX
    package's own test allows."""
    return (tid_a != tid_b).mean() < 0.01


@pytest.mark.parametrize("tile_h,tile_w,expand", [(8, 128, 8), (16, 32, 2)])
def test_plain_pair_raster_matches_pallas_interpret(tile_h, tile_w, expand):
    js, _ = _setups(7, n=200)
    jpairs = jp.build_pairs(js, W, H, tile_h, tile_w, expand=expand,
                            sort_z=True)
    jd, jt = jp.rasterize_pairs(jpairs, H, W, tile_h=tile_h, tile_w=tile_w,
                                interpret=True)
    pairs = pairs_from_numpy(to_numpy_leaves(jpairs), "cpu")
    td, tt = tp.rasterize_pairs(pairs, H, W, tile_h=tile_h, tile_w=tile_w)
    # 5e-5: the TPU kernel packs depth into a 2^16-level winner key.
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=5e-5)
    assert _off_ties(td.numpy(), tt.numpy(), np.asarray(jt))
    # The pair path equals the brute-force rasterizer of the same package
    # exactly in depth (same arithmetic), ids off exact ties.
    ts = setup_from_numpy(to_numpy_leaves(js), "cpu")
    bd, bt = tr.rasterize_visibility(ts, H, W)
    np.testing.assert_array_equal(td.numpy(), bd.numpy())
    assert (tt.numpy() != bt.numpy()).mean() < 0.002


def test_plain_pair_raster_depth_only_and_init_depth():
    js, _ = _setups(11, n=120)
    jpairs = jp.build_pairs(js, W, H, 8, 128, sort_z=True, ysort_sub_rows=8)
    pairs = pairs_from_numpy(to_numpy_leaves(jpairs), "cpu")
    jd = jp.rasterize_pairs(jpairs, H, W, tile_h=8, tile_w=128,
                            depth_only=True, interpret=True, y_row=13)
    td = tp.rasterize_pairs(pairs, H, W, tile_h=8, tile_w=128,
                            depth_only=True, y_row=13)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=5e-5)

    init = np.full((H, W), 0.4, np.float32)
    jd2, jt2 = jp.rasterize_pairs(jpairs, H, W, init_depth=jnp.asarray(init),
                                  tile_h=8, tile_w=128, interpret=True,
                                  y_row=13)
    td2, tt2 = tp.rasterize_pairs(pairs, H, W,
                                  init_depth=torch.from_numpy(init),
                                  tile_h=8, tile_w=128, y_row=13)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), atol=5e-5)
    assert _off_ties(td2.numpy(), tt2.numpy(), np.asarray(jt2))
    # init_depth wins ties: nothing at or behind 0.4 is a winner.
    assert (tt2.numpy()[td2.numpy() >= 0.4] == -1).all()
    assert float(td2.max()) <= float(np.float32(0.4))


def test_winner_rule_lowest_pair_id_at_exact_ties():
    """Two coincident triangles: the winner is the one whose pair sorts
    first (stable sort keeps triangle order inside equal keys), in every
    tile, dense or supertile."""
    clip = _random_clip(13, n=6)
    clip[1] = clip[0]
    clip[3] = clip[2] = clip[0] * np.float32(1.0)
    ts = tr.triangle_setup(torch.from_numpy(clip), W, H, two_sided=True)
    pairs = tp.build_pairs(ts, W, H, 8, 128, expand=2, sort_z=True)
    depth, tid = tp.rasterize_pairs(pairs, H, W, tile_h=8, tile_w=128)
    bd, bt = tr.rasterize_visibility(ts, H, W)
    np.testing.assert_array_equal(depth.numpy(), bd.numpy())
    cov = tid.numpy() >= 0
    assert cov.any()
    assert not np.isin(tid.numpy()[cov], [1, 2, 3]).any()


def test_wrappers_refuse_cpu_tensors_for_the_cuda_backend():
    _, ts = _setups(5)
    pairs = tp.build_pairs(ts, W, H, 8, 128)
    with pytest.raises(RuntimeError, match="card"):
        tp.rasterize_pairs(pairs, H, W, tile_h=8, tile_w=128, backend="cuda")
    assert tp.rasterize_pairs.launches == 0


@pytest.mark.parametrize("height,width,tile_h,tile_w", [
    (72, 96, 24, 32), (64, 128, 64, 32), (64, 128, 8, 128), (72, 96, 24, 24)])
def test_strip_walk_skips_only_pairs_that_cover_nothing(height, width,
                                                        tile_h, tile_w):
    """``strip_walk_hits`` / ``strip_walk_tests`` model what kernel
    ``pair_raster_fused`` tests: no pair a warp skips covers a pixel of that
    warp (the skip is exact), and without a span column every warp that
    owns pixels tests every pair against all of its 32 * NPP slots."""
    clip = _random_clip(21, n=300)
    clip[5, 0, 3] = -0.5  # crosses the camera plane: full-screen bbox
    ts = tr.triangle_setup(torch.from_numpy(clip), width, height,
                           two_sided=True)
    n_extra = tp.fused_extra_width(need_uv=False, need_combo=False)
    extra = torch.from_numpy(
        np.random.default_rng(4).random((300, n_extra)).astype(np.float32))
    pairs = tp.build_pairs(ts, width, height, tile_h, tile_w, expand=4,
                           extra=extra, sort_z=True, ysort_sub_rows=8)
    y_row = 12 + n_extra + 1  # after the payload and the z column
    tiles, pids, hit = tp.strip_walk_hits(pairs, height, width, tile_h,
                                          tile_w, 8, y_row)
    # Coverage of every (tile, pair) entry at every pixel of the tile, by
    # the plain version's arithmetic, folded onto the 8 warps.
    n_tx = width // tile_w
    run = 32 * tp._pixels_per_thread(tile_h, tile_w)
    loc = torch.arange(tile_h * tile_w)
    gx = (tiles % n_tx)[:, None] * tile_w + loc % tile_w
    gy = (tiles // n_tx)[:, None] * tile_h + loc // tile_w
    px, py = gx.float() + 0.5, gy.float() + 0.5
    r = pairs.records[pids]
    e = [px * r[:, 3 * i : 3 * i + 1] + py * r[:, 3 * i + 1 : 3 * i + 2]
         + r[:, 3 * i + 2 : 3 * i + 3] for i in range(3)]
    d = e[0] * r[:, 9:10] + e[1] * r[:, 10:11] + e[2] * r[:, 11:12]
    inside = ((torch.minimum(torch.minimum(e[0], e[1]), e[2]) >= 0)
              & (e[0] + e[1] + e[2] > 0) & (d >= 0) & (d <= 1))
    covers = torch.zeros_like(hit).index_put_(
        (torch.arange(tiles.shape[0])[:, None].expand_as(inside),
         (loc // run)[None, :].expand_as(inside)), inside, accumulate=True)
    assert covers.any(1).float().mean() > 0.3
    assert not (covers & ~hit).any()
    skipped = tp.strip_walk_tests(pairs, height, width, tile_h, tile_w, 8,
                                  y_row)
    assert int(skipped.sum()) == int(hit.sum()) * run
    full = tp.strip_walk_tests(pairs, height, width, tile_h, tile_w)
    owning = -(-(tile_h * tile_w) // run)
    assert int(full.sum()) == tiles.shape[0] * owning * run
    assert int(skipped.sum()) < int(full.sum())
    # The wrapper names the span column and the strip height it is given.
    with pytest.raises(ValueError, match="not a column"):
        tp.rasterize_pairs_fused(pairs, height, width, tile_h=tile_h,
                                 tile_w=tile_w, y_row=pairs.records.shape[1],
                                 need_uv=False, has_combo=False)
    with pytest.raises(ValueError, match="sub_rows"):
        tp.rasterize_pairs_fused(pairs, height, width, tile_h=tile_h,
                                 tile_w=tile_w, sub_rows=0, y_row=y_row,
                                 need_uv=False, has_combo=False)
