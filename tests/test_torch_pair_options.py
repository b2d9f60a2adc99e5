"""Aligned pair bins and the occlusion early-out of the port's pair
rasterizers against the JAX package: ``build_pairs(align=True)`` gives the
JAX package's arrays (as tests/test_rasterize_pallas.py:281 checks them),
and the plain early-out walk (``early_out_walk``, the rule kernels
``pair_raster`` and ``pair_raster_fused`` apply) gives the JAX package's
brute-force ``rasterize_visibility`` / ``rasterize_depth`` bit for bit on
aligned and unaligned bins (tests/test_rasterize_pallas.py:175's case),
and skips pairs where a near occluder covers a crowded tile."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.ops import rasterize as jr
from zeldaengine_tpu.ops import rasterize_pallas as jp
from zeldaengine_tpu_torch.convert import pairs_from_numpy, setup_from_numpy
from zeldaengine_tpu_torch.ops import rasterize as tr
from zeldaengine_tpu_torch.ops import rasterize_cuda as tp

from _torch_compare import to_numpy_leaves
from _torch_raster_inputs import H, W, setups as _setups

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [{}, {"sort_z": True}, {"max_pairs": 512}],
                         ids=["plain", "sort_z", "max_pairs"])
def test_aligned_bins_equal_to_jax(kw):
    """Every array equal; every walked bin starts on a 128-pair boundary;
    the pad positions hold the dead triangle's never-record; the plain
    raster of the aligned stream equals the unaligned one's."""
    js, _ = _setups(5)
    ts = setup_from_numpy(to_numpy_leaves(js), "cpu")
    jpairs = jp.build_pairs(js, W, H, 8, 128, expand=8, align=True, **kw)
    tpairs = tp.build_pairs(ts, W, H, 8, 128, expand=8, align=True, **kw)
    carried = pairs_from_numpy(to_numpy_leaves(jpairs), "cpu")
    for name in ("starts", "ends", "sstarts", "sends", "gbounds",
                 "pair_tri"):
        np.testing.assert_array_equal(
            getattr(tpairs, name).numpy(), getattr(carried, name).numpy(),
            err_msg=name)
    np.testing.assert_array_equal(tpairs.records.numpy(),
                                  carried.records.numpy())
    assert int(tpairs.overflow) == int(jpairs.overflow)
    for lo in (tpairs.starts, tpairs.sstarts, tpairs.gbounds[:1]):
        assert int((lo % 128).abs().sum()) == 0
    pad = tpairs.pair_tri == ts.edge.shape[0]
    assert bool(pad.any())
    assert bool((tpairs.records[pad][:, [2, 5, 8]] == -1.0).all())
    plain = tp.build_pairs(ts, W, H, 8, 128, expand=8, **kw)
    for a, b in zip(tp.rasterize_pairs(tpairs, H, W, tile_h=8, tile_w=128),
                    tp.rasterize_pairs(plain, H, W, tile_h=8, tile_w=128)):
        assert torch.equal(a, b)


def _early_out_case():
    """tests/test_rasterize_pallas.py:175: 300 random triangles over a
    64x128 frame, binned in 16x32 tiles front to back."""
    rng = np.random.default_rng(0)
    v = rng.uniform(-1.2, 1.2, (300, 3, 4)).astype(np.float32)
    v[..., 3] = rng.uniform(0.5, 3.0, (300, 3)).astype(np.float32)
    v[..., 2] = rng.uniform(0.0, 1.0, (300, 3)) * v[..., 3]
    js = jr.triangle_setup(jnp.asarray(v), W, H)
    return js, setup_from_numpy(to_numpy_leaves(js), "cpu")


@pytest.mark.parametrize("align", [False, True])
def test_early_out_equals_the_brute_force_reference(align):
    """Depth and winner ids, and depth only, at eo_stride 1 and 4, through
    the kernel's split of tiles and in one block a tile: bit for bit with
    the JAX package's brute-force rasterizers."""
    js, ts = _early_out_case()
    d_ref, t_ref = (np.asarray(a) for a in
                    jr.rasterize_visibility(js, H, W, chunk=64))
    dref = np.asarray(jr.rasterize_depth(js, H, W, chunk=64))
    pairs = tp.build_pairs(ts, W, H, 16, 32, expand=8, sort_z=True,
                           align=align)
    kw = dict(tile_h=16, tile_w=32, early_out=True, z_row=12)
    for stride in (1, 4):
        for parts in (tp.SPLIT_PARTS, 1):
            skipped = torch.zeros(1, dtype=torch.int32)
            d, t = tp.rasterize_pairs_plain(
                pairs, H, W, **kw, eo_stride=stride, eo_skipped=skipped,
                split_parts=parts)
            np.testing.assert_array_equal(d.numpy(), d_ref)
            np.testing.assert_array_equal(t.numpy(), t_ref)
            do = tp.rasterize_pairs_plain(
                pairs, H, W, **kw, eo_stride=stride, depth_only=True,
                split_parts=parts)
            np.testing.assert_array_equal(do.numpy(), dref)
    # Under a span column the early-out is off (y-bucketed bins are not
    # sorted by z), as in the JAX package.
    ypairs = tp.build_pairs(ts, W, H, 16, 32, expand=8, sort_z=True,
                            ysort_sub_rows=8, align=align)
    skipped = torch.zeros(1, dtype=torch.int32)
    d, t = tp.rasterize_pairs(ypairs, H, W, **kw, y_row=13, eo_stride=1,
                              eo_skipped=skipped)
    assert int(skipped) == 0
    np.testing.assert_array_equal(t.numpy(), t_ref)


def _occluded_tile(seed=3, n=3000):
    """A 32x64 frame in 16x32 tiles: a full-screen quad at depth 0.05 in
    front of ``n`` small triangles (depths 0.3-0.9) crowding tile (0, 0),
    binned front to back with a fused payload."""
    rng = np.random.default_rng(seed)
    h, w = 32, 64
    quad = np.array([[[-1, -1], [1, -1], [1, 1]], [[-1, -1], [1, 1],
                                                   [-1, 1]]], np.float32)
    cx = rng.uniform(0.0, 32.0, (n, 1))
    cy = rng.uniform(0.0, 16.0, (n, 1))
    px = np.clip(cx + rng.uniform(-3.0, 3.0, (n, 3)), 0.0, 32.0)
    py = np.clip(cy + rng.uniform(-3.0, 3.0, (n, 3)), 0.0, 16.0)
    small = np.stack([px / w * 2.0 - 1.0, py / h * 2.0 - 1.0], -1)
    xy = np.concatenate([quad, small.astype(np.float32)])
    z = np.concatenate([np.full((2, 3, 1), 0.05),
                        np.repeat(rng.uniform(0.3, 0.9, (n, 1, 1)), 3, 1)])
    clip = np.concatenate([xy, z, np.ones_like(z)], -1).astype(np.float32)
    setup = tr.triangle_setup(torch.from_numpy(clip), w, h, two_sided=True)
    extra = torch.from_numpy(rng.random((n + 2, tp.fused_extra_width()))
                             .astype(np.float32))
    pairs = tp.build_pairs(setup, w, h, 16, 32, expand=8, sort_z=True,
                           extra=extra)
    return pairs, h, w


def test_early_out_skips_behind_a_near_occluder():
    """The tile's range starts with the occluder (lowest z bucket); after
    its first test every pixel lies nearer than the next bucket, and the
    rest of the range is skipped: in one block a tile (as kernel
    ``pair_raster_fused``) and in the part of the split that holds the
    occluder (kernel ``pair_raster``). The images equal the walk without
    the early-out; K1 in one block a tile and K2 skip the same pairs."""
    pairs, h, w = _occluded_tile()
    kw = dict(tile_h=16, tile_w=32)
    eo = dict(early_out=True, z_row=12 + tp.fused_extra_width(),
              eo_stride=1)
    counts = {}
    for parts in (1, tp.SPLIT_PARTS):
        counts[parts] = torch.zeros(1, dtype=torch.int32)
        d, t = tp.rasterize_pairs_plain(pairs, h, w, **kw, **eo,
                                        eo_skipped=counts[parts],
                                        split_parts=parts)
        d0, t0 = tp.rasterize_pairs_plain(pairs, h, w, **kw)
        assert torch.equal(d, d0) and torch.equal(t, t0)
    fused = torch.zeros(1, dtype=torch.int32)
    out = tp.rasterize_pairs_fused(pairs, h, w, **kw, **eo,
                                   eo_skipped=fused)
    ref = tp.rasterize_pairs_fused(pairs, h, w, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert bool((out[1] >= 0).all()) and bool((out[1] <= 1).all())
    n_tile0 = int(pairs.ends[0] - pairs.starts[0])
    assert n_tile0 > 2500
    assert int(fused) == int(counts[1]) >= n_tile0 - 2 * 64
    assert 0 < int(counts[tp.SPLIT_PARTS]) < int(counts[1])
