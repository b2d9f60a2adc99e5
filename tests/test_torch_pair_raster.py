"""The plain version of kernel ``pair_raster`` against the Pallas kernel in
interpret mode and against the port's brute-force rasterizer, the winner
rule at exact ties, and the wrappers' device rule. The CUDA kernel itself
is held against this plain version on the card by chip_smoke.py. The
strip walk's skip rule is in test_torch_pair_raster_walk.py, the split of
crowded tiles in test_torch_pair_raster_split.py."""

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
