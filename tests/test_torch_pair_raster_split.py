"""Kernel ``pair_raster``'s split of crowded tiles over several blocks, in
PyTorch (``rasterize_pairs_split_plain``), against the plain walk."""

import numpy as np
import pytest
import torch

from zeldaengine_tpu_torch.ops import rasterize as tr
from zeldaengine_tpu_torch.ops import rasterize_cuda as tp

from _torch_raster_inputs import H, W, random_clip as _random_clip

torch.set_num_threads(1)


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
