"""The plain version of kernel ``pair_raster`` against the Pallas kernel in
interpret mode and against the port's brute-force rasterizer, the winner
rule at exact ties, and the wrappers' device rule. The CUDA kernel itself
is held against this plain version on the card by chip_smoke.py."""

import functools

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
    """The gather layouts give the same records. ``align`` was refused
    until the aligned bins were ported; it now moves the records to
    128-pair boundaries and rasterizes to the same buffers
    (tests/test_torch_pair_options.py holds it against the JAX
    package)."""
    _, ts = _setups(5)
    a = tp.build_pairs(ts, W, H, 8, 128)
    b = tp.build_pairs(ts, W, H, 8, 128, gather_chunks=4, gather_pack=8)
    np.testing.assert_array_equal(a.records.numpy(), b.records.numpy())
    c = tp.build_pairs(ts, W, H, 8, 128, align=True)
    assert int((c.starts % 128).abs().sum()) == 0
    for x, y in zip(tp.rasterize_pairs(a, H, W, tile_h=8, tile_w=128),
                    tp.rasterize_pairs(c, H, W, tile_h=8, tile_w=128)):
        assert torch.equal(x, y)


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
    # The plain walk in many chunks (its id pass too) gives the same.
    init_t = torch.from_numpy(init)
    one = tp._plain_visibility(pairs, H, W, init_t, 8, 128, y_row=13)
    many = tp._plain_visibility(pairs, H, W, init_t, 8, 128, y_row=13,
                                chunk_elems=4096)
    assert all(torch.equal(a, b) for a, b in zip(one, many))


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


@pytest.mark.parametrize("depth_only", [True, False])
@pytest.mark.parametrize("with_init", [False, True])
def test_split_merge_equals_the_plain_walk(depth_only, with_init):
    """Kernel ``pair_raster``'s split of crowded tiles, in PyTorch
    (``rasterize_pairs_split_plain``): the plain walk over contiguous parts
    of each tile's sequence, merged by the 64-bit (depth, order + 1, sign)
    key with init keyed as order 0, equals the plain walk over the whole
    sequence bit for bit, the sign of a winning zero included. Parts of 4
    pairs (the kernel stages 64) put many part boundaries into a small
    stream; triples of coincident triangles place exact depth ties across
    them, init_depth equals a candidate's depth at half the pixels, where
    init must win. Two coincident pairs lying in two parts get depth
    planes of -0.0 and +0.0: where the first is -0.0 it wins with -0.0
    across the part boundary, where the first is +0.0 a later -0.0 does
    not replace it."""
    clip = _random_clip(31, n=240)
    clip[5, 0, 3] = -0.5  # crosses the camera plane: a supertile pair
    clip[60:120] = clip[0:60]
    clip[120:180] = clip[0:60]
    ts = tr.triangle_setup(torch.from_numpy(clip), W, H, two_sided=True)
    pairs = tp.build_pairs(ts, W, H, 32, 32, expand=4, sort_z=True,
                           ysort_sub_rows=8)
    split = dict(split_parts=8, split_min_chunks=1, chunk=4)
    tiles, pids, part, split_tiles = tp.split_parts_of(pairs, H, W, 32, 32,
                                                       **split)
    assert bool(split_tiles.all())
    # A tile's sequence (dense, supertile, global pairs) runs 0..n-1 in
    # ascending pair id, and its parts follow it in order.
    _, _, seq = tp._tile_pair_seq(pairs, H // 32, W // 32, 32, 32)
    order = torch.argsort(tiles * (1 << 32) + seq)
    t, sq, pi, pa = tiles[order], seq[order], pids[order], part[order]
    first = torch.ones_like(t, dtype=torch.bool)
    first[1:] = t[1:] != t[:-1]
    same = ~first[1:]
    assert bool((sq[first] == 0).all())
    assert bool((sq[1:][same] == sq[:-1][same] + 1).all())
    assert bool((pi[1:][same] > pi[:-1][same]).all())
    assert bool((pa[1:][same] >= pa[:-1][same]).all())
    assert int((pairs.sends - pairs.sstarts).sum()) > 0
    # Some triple of coincident pairs of one tile lies in two parts.
    copies = tiles * 60 + pairs.pair_tri.long()[pids] % 60
    lo = torch.full((int(copies.max()) + 1,), 99).scatter_reduce(
        0, copies, part, "amin")
    hi = torch.full_like(lo, -1).scatter_reduce(0, copies, part, "amax")
    assert bool((hi > lo).any())
    # Two triangles of 0..59 whose first two copies lie in two parts of
    # one tile, each winning >= 16 pixels: the first gets depth planes
    # (-0.0, +0.0) on its copies, the second (+0.0, -0.0).
    wins = tp.rasterize_pairs_plain(pairs, H, W, None, 32, 32)[1]
    counts = torch.bincount(wins[wins >= 0].long(), minlength=240)
    tri_of = pairs.pair_tri.long()[pids]
    straddle = set()
    for c in range(60):
        a, b = tri_of == c, tri_of == c + 60
        for t in set(tiles[a].tolist()) & set(tiles[b].tolist()):
            if int(part[a & (tiles == t)][0]) != int(part[b & (tiles == t)][0]):
                straddle.add(c)
    picks = sorted((c for c in straddle if counts[c] >= 16),
                   key=lambda c: -int(counts[c]))
    assert len(picks) >= 2, picks
    for c, signs in zip(picks[:2], ((-0.0, 0.0), (0.0, -0.0))):
        for copy, z in zip((c, c + 60), signs):
            pairs.records[pairs.pair_tri == copy, 9:12] = z
    init = None
    if with_init:
        rng = np.random.default_rng(3)
        d0 = tp.rasterize_pairs_plain(pairs, H, W, None, 32, 32, True)
        init = torch.from_numpy(np.where(
            rng.random((H, W)) < 0.5, d0.numpy(),
            rng.uniform(0.3, 1.0, (H, W))).astype(np.float32))
    want = tp.rasterize_pairs_plain(pairs, H, W, init, 32, 32, depth_only)
    got = tp.rasterize_pairs_split_plain(pairs, H, W, init, 32, 32,
                                         depth_only, **split)
    if depth_only:
        got, want = (got,), (want,)
    bits = lambda t: t.view(torch.int32).numpy()  # noqa: E731
    minus_zero = bits(torch.tensor(-0.0))
    # Candidates win with -0.0 and with +0.0; with init_depth, an init of
    # -0.0 (and of +0.0) wins the tie at about half of those pixels.
    full_depth, ids = tp.rasterize_pairs_plain(pairs, H, W, init, 32, 32)
    ids = ids.numpy()
    # The plain walk's depth is the winner's, depth only or with ids.
    np.testing.assert_array_equal(bits(want[0]), bits(full_depth))
    for c, z in zip(picks[:2], (minus_zero, 0)):
        mine = ids == c
        assert mine.sum() >= 8
        assert (bits(want[0])[mine] == z).all()
    if with_init:
        assert ((bits(init) == minus_zero) & (ids < 0)).sum() >= 4
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    if not depth_only:
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        assert (want[1].numpy() >= 0).mean() > 0.05
    # At the kernel's own part sizes the stream is not split: the tiles
    # keep their one-part result, -0.0 included.
    np.testing.assert_array_equal(
        bits(tp.rasterize_pairs_split_plain(pairs, H, W, init, 32, 32, True)),
        bits(want[0]))
