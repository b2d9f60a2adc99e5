"""Row bands of the pair rasterizers (``y0_tiles``: kernels ``pair_raster``
and ``pair_raster_fused`` rasterize the band of tile rows [y0_tiles,
y0_tiles + rows / tile_h) into band-sized buffers) and the host maths of
``parallel/tiles.py``. The plain versions in a band against the JAX
package's ``rasterize_pairs*(..., y0_tiles=, interpret=True)`` and against
the same rows of the full raster, as tests/test_rasterize_pallas.py:55
holds the JAX kernel's band; the split and early-out walks in a band; the
stripe layout, its permutation and the band compaction against the JAX
package's. The CUDA kernels in a band are held against these plain
versions on the card by chip_smoke.py (phase ``bands``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.ops import rasterize as jr
from zeldaengine_tpu.ops import rasterize_pallas as jp
from zeldaengine_tpu.parallel import tiles as jtiles
from zeldaengine_tpu.scene.scenebuild import SceneMeta as JMeta
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import pairs_from_numpy, setup_from_numpy
from zeldaengine_tpu_torch.ops import rasterize_cuda as tp
from zeldaengine_tpu_torch.parallel import (
    band_compact_config, stripe_layout, unstripe_perm)
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta

from _torch_compare import to_numpy_leaves
from _torch_raster_inputs import H, W, setups as _setups

torch.set_num_threads(1)


def _carried(seed, n):
    """The JAX setup of seeded triangles and the same setup carried across
    as NumPy: both rasterizers read one set of records."""
    js, _ = _setups(seed, n=n)
    return js, setup_from_numpy(to_numpy_leaves(js), "cpu")


def _bits(t):
    return t.view(torch.int32).numpy() if t.dtype == torch.float32 \
        else t.numpy()


@pytest.mark.parametrize("tile_h,tile_w,y0_tiles,n_ty", [
    (8, 128, 2, 3), (16, 32, 1, 2)])
def test_band_pair_raster_matches_pallas_interpret_and_full_rows(
        tile_h, tile_w, y0_tiles, n_ty):
    """Depth and ids (and depth only) of a band, with and without the
    strip span, bit for bit with the JAX kernel's band in interpret mode on
    the same pairs, and with the same rows of the port's full raster; an
    initial depth in a band too."""
    js, ts = _carried(7, n=200)
    rows, y0 = n_ty * tile_h, y0_tiles * tile_h
    init = np.random.default_rng(2).uniform(0.6, 1.0, (H, W)).astype(
        np.float32)
    for span in (None, 8):
        y_row = 13 if span else -1
        kw = dict(tile_h=tile_h, tile_w=tile_w, y_row=y_row)
        jpairs = jp.build_pairs(js, W, rows, tile_h, tile_w, sort_z=True,
                                ysort_sub_rows=span, y0_tiles=y0_tiles)
        jd, jt = jp.rasterize_pairs(jpairs, rows, W, y0_tiles=y0_tiles,
                                    interpret=True, **kw)
        pairs = tp.build_pairs(ts, W, rows, tile_h, tile_w, sort_z=True,
                               ysort_sub_rows=span, y0_tiles=y0_tiles)
        carried = pairs_from_numpy(to_numpy_leaves(jpairs), "cpu")
        np.testing.assert_array_equal(pairs.records.numpy(),
                                      carried.records.numpy())
        full = tp.build_pairs(ts, W, H, tile_h, tile_w, sort_z=True,
                              ysort_sub_rows=span)
        fd, ft = tp.rasterize_pairs(full, H, W, **kw)
        td, tt = tp.rasterize_pairs(pairs, rows, W, y0_tiles=y0_tiles, **kw)
        np.testing.assert_array_equal(_bits(td), np.asarray(jd).view(
            np.int32))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(_bits(td), _bits(fd[y0:y0 + rows]))
        np.testing.assert_array_equal(tt.numpy(), ft[y0:y0 + rows].numpy())
        assert (tt.numpy() >= 0).mean() > 0.1
        do = tp.rasterize_pairs(pairs, rows, W, y0_tiles=y0_tiles,
                                depth_only=True, **kw)
        np.testing.assert_array_equal(_bits(do), _bits(td))
        # An initial depth: the band's rows of the full frame's.
        band_init = torch.from_numpy(init[y0:y0 + rows].copy())
        jd2, jt2 = jp.rasterize_pairs(
            jpairs, rows, W, init_depth=jnp.asarray(init[y0:y0 + rows]),
            y0_tiles=y0_tiles, interpret=True, **kw)
        td2, tt2 = tp.rasterize_pairs(pairs, rows, W, init_depth=band_init,
                                      y0_tiles=y0_tiles, **kw)
        fd2, ft2 = tp.rasterize_pairs(full, H, W,
                                      init_depth=torch.from_numpy(init), **kw)
        np.testing.assert_array_equal(_bits(td2), np.asarray(jd2).view(
            np.int32))
        np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt2))
        np.testing.assert_array_equal(_bits(td2), _bits(fd2[y0:y0 + rows]))
        np.testing.assert_array_equal(tt2.numpy(),
                                      ft2[y0:y0 + rows].numpy())


def test_band_fused_raster_matches_pallas_interpret_and_full_rows():
    """The fused raster's band: depth, ids and the 24 attribute planes
    against the JAX fused kernel's band (interpret mode; planes within
    the fused tests' 2e-5) and bit for bit against the same rows of the
    port's full fused raster, with and without the strip span."""
    js, ts = _carried(9, n=200)
    rng = np.random.default_rng(4)
    n_extra = tp.fused_extra_width()
    extra = rng.random((200, n_extra)).astype(np.float32)
    tile_h, tile_w, y0_tiles, rows = 16, 32, 2, 32
    y0 = y0_tiles * tile_h
    for span in (None, 8):
        y_row = 12 + n_extra + 1 if span else -1
        kw = dict(tile_h=tile_h, tile_w=tile_w, y_row=y_row,
                  texture_size=64)
        jpairs = jp.build_pairs(js, W, rows, tile_h, tile_w, sort_z=True,
                                ysort_sub_rows=span, y0_tiles=y0_tiles,
                                extra=jnp.asarray(extra))
        jd, jt, jpl = jp.rasterize_pairs_fused(
            jpairs, rows, W, y0_tiles=y0_tiles, interpret=True,
            z_row=12 + n_extra, **kw)
        pairs = tp.build_pairs(ts, W, rows, tile_h, tile_w, sort_z=True,
                               ysort_sub_rows=span, y0_tiles=y0_tiles,
                               extra=torch.from_numpy(extra))
        td, tt, tpl = tp.rasterize_pairs_fused(pairs, rows, W,
                                               y0_tiles=y0_tiles, **kw)
        np.testing.assert_array_equal(_bits(td), np.asarray(jd).view(
            np.int32))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        cov = tt.numpy() >= 0
        assert cov.mean() > 0.1
        np.testing.assert_allclose(tpl.numpy()[:, cov],
                                   np.asarray(jpl)[:, cov], atol=2e-5,
                                   rtol=2e-5)
        full = tp.build_pairs(ts, W, H, tile_h, tile_w, sort_z=True,
                              ysort_sub_rows=span,
                              extra=torch.from_numpy(extra))
        fd, ft, fpl = tp.rasterize_pairs_fused(full, H, W, **kw)
        np.testing.assert_array_equal(_bits(td), _bits(fd[y0:y0 + rows]))
        np.testing.assert_array_equal(tt.numpy(), ft[y0:y0 + rows].numpy())
        np.testing.assert_array_equal(_bits(tpl),
                                      _bits(fpl[:, y0:y0 + rows].contiguous()))


def test_band_split_and_early_out_walks():
    """In a band: the split of crowded tiles (kernel ``pair_raster``'s
    merge, ``rasterize_pairs_split_plain``) equals the plain walk bit for
    bit; the occlusion early-out (``early_out_walk``, through the split and
    in one block a tile) equals the JAX package's brute-force raster of the
    band's rows bit for bit, and equals the JAX kernel's band with its own
    early-out in interpret mode."""
    js, ts = _carried(31, n=300)
    tile_h, tile_w, y0_tiles, rows = 16, 32, 1, 32
    y0 = y0_tiles * tile_h
    pairs = tp.build_pairs(ts, W, rows, tile_h, tile_w, expand=4,
                           sort_z=True, ysort_sub_rows=8, y0_tiles=y0_tiles)
    kw = dict(tile_h=tile_h, tile_w=tile_w, y_row=13, y0_tiles=y0_tiles)
    want = tp.rasterize_pairs_plain(pairs, rows, W, **kw)
    split = dict(split_parts=8, split_min_chunks=1, chunk=4)
    assert bool(tp.split_parts_of(pairs, rows, W, tile_h, tile_w,
                                  **split)[3].any())
    for depth_only in (True, False):
        got = tp.rasterize_pairs_split_plain(
            pairs, rows, W, None, tile_h, tile_w, depth_only, **split,
            sub_rows=8, y_row=13, y0_tiles=y0_tiles)
        got = got if depth_only else got[0]
        np.testing.assert_array_equal(_bits(got), _bits(want[0]))
    got = tp.rasterize_pairs_split_plain(
        pairs, rows, W, None, tile_h, tile_w, False, **split, sub_rows=8,
        y_row=13, y0_tiles=y0_tiles)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())

    d_ref, t_ref = (np.asarray(a)[y0:y0 + rows] for a in
                    jr.rasterize_visibility(js, H, W, chunk=64))
    zpairs = tp.build_pairs(ts, W, rows, tile_h, tile_w, expand=8,
                            sort_z=True, y0_tiles=y0_tiles)
    eo = dict(tile_h=tile_h, tile_w=tile_w, early_out=True, z_row=12,
              eo_stride=1, y0_tiles=y0_tiles)
    for parts in (tp.SPLIT_PARTS, 1):
        skipped = torch.zeros(1, dtype=torch.int32)
        d, t = tp.rasterize_pairs_plain(zpairs, rows, W, **eo,
                                        eo_skipped=skipped,
                                        split_parts=parts)
        np.testing.assert_array_equal(d.numpy(), d_ref)
        np.testing.assert_array_equal(t.numpy(), t_ref)
    jz = jp.build_pairs(js, W, rows, tile_h, tile_w, expand=8, sort_z=True,
                        y0_tiles=y0_tiles)
    jd, jt = jp.rasterize_pairs(jz, rows, W, interpret=True, **eo)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_stripe_layout_permutation_and_band_compaction_equal_jax():
    """Host maths of parallel/tiles.py against the JAX package's, for 1, 3
    and 8 devices at TEST_CONFIG and at bench config 3's shape (1080 rows
    in 64-row tiles: 17 tile rows, the last strips past the frame)."""
    shapes = [dict(), dict(width=1920, height=1080, tile_h=64, tile_w=32)]
    for kw in shapes:
        cfg, jcfg = TEST_CONFIG.replace(**kw), JCFG.replace(**kw)
        for n in (1, 3, 8):
            assert stripe_layout(cfg, n) == jtiles.stripe_layout(jcfg, n)
            perm = unstripe_perm(cfg, n)
            assert perm.dtype == torch.int64
            np.testing.assert_array_equal(
                perm.numpy(), np.asarray(jtiles.unstripe_perm(jcfg, n)))
            # Screen order: the first ``height`` rows are each rendered
            # once.
            assert sorted(perm[:cfg.height].tolist()) == sorted(
                set(perm[:cfg.height].tolist()))
            for t, slack in ((100, 2.0), (87130, 2.0), (87130, 1.0),
                             (500000, 3.0)):
                meta = SceneMeta(num_triangles=t)
                jmeta = JMeta(num_triangles=t)
                got = band_compact_config(cfg, meta, n, slack)
                want = jtiles.band_compact_config(jcfg, jmeta, n, slack)
                assert got.compact_tris == want.compact_tris, (t, n, slack)
            preset = cfg.replace(compact_tris=4096)
            big = SceneMeta(num_triangles=10 ** 6)
            assert band_compact_config(preset, big, n) is preset
