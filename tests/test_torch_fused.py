"""Plain version of kernel pair_raster_fused against the Pallas fused
kernel in interpret mode, with and without the kernel's strip-span skip, on
the pair stream the JAX package built (carried across by
convert.pairs_from_numpy), and the visibility pass it shares with the
unfused raster (the property that makes the skip exact is in
test_torch_fused_span.py). The CUDA kernel itself is held against this
plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops import rasterize_pallas as jp
from zeldaengine_tpu.passes import frame as jframe
from zeldaengine_tpu_torch.convert import (
    pairs_from_numpy, scene_from_numpy, setup_from_numpy, view_from_numpy)
from zeldaengine_tpu_torch.math.transforms import (
    apply_mat4_point as t_apply_point)
from zeldaengine_tpu_torch.ops import pbr as tpbr
from zeldaengine_tpu_torch.ops import rasterize_cuda as tp
from zeldaengine_tpu_torch.passes import frame as tframe

from _torch_compare import to_numpy_leaves
from _torch_fused_state import H, W, fused_state

torch.set_num_threads(1)

state = pytest.fixture(scope="module")(fused_state)


def _run(state, need_uv, has_combo, tile_h, tile_w, span=False):
    """The JAX fused kernel (interpret mode) and the port's plain version
    on one pair stream; ``span``: the JAX kernel skips by the packed strip
    span (its ``y_row`` / ``sub_rows`` path), the port's wrapper is given
    the same column."""
    cfg, scene, view, world, n_world, setup, _ = state
    extra = jframe._fused_extra(scene, setup, world, n_world,
                                need_uv=need_uv, need_combo=has_combo)
    jpairs = jp.build_pairs(setup, W, H, tile_h, tile_w, extra=extra,
                            sort_z=True, ysort_sub_rows=8)
    # The span column follows the payload and the z column.
    y_row = 12 + extra.shape[1] + 1 if span else -1
    jd, jt, jplanes = jp.rasterize_pairs_fused(
        jpairs, H, W, tile_h=tile_h, tile_w=tile_w, sub_rows=8,
        texture_size=cfg.texture_size, interpret=True, y_row=y_row,
        need_uv=need_uv, has_combo=has_combo, combo_const=0.0)
    pairs = pairs_from_numpy(to_numpy_leaves(jpairs), "cpu")
    td, tt, tplanes = tp.rasterize_pairs_fused(
        pairs, H, W, tile_h=tile_h, tile_w=tile_w, sub_rows=8,
        texture_size=cfg.texture_size, y_row=y_row, need_uv=need_uv,
        has_combo=has_combo, combo_const=0.0)
    return (np.asarray(jd), np.asarray(jt), np.asarray(jplanes),
            td.numpy(), tt.numpy(), tplanes.numpy())


def _assert_fused_close(jd, jt, jpl, td, tt, tpl, need_uv):
    assert tpl.shape == (tp.ATTR_CH, H, W) == jpl.shape
    # 5e-5: the TPU kernel's phase 1 packs depth into a 2^16-level key.
    np.testing.assert_allclose(td, jd, atol=5e-5)
    same = (tt == jt)
    assert same.mean() > 0.99  # ids equal off near-ties
    cov = (jt >= 0) & same
    assert cov.mean() > 0.3
    # 2e-4 abs+rel on covered pixels with the same winner: the figure of
    # tests/test_fused.py (XLA contracts FMAs; 1/esum amplifies an ulp).
    for c in range(tp.ATTR_CH):
        np.testing.assert_allclose(tpl[c][cov], jpl[c][cov], atol=2e-4,
                                   rtol=2e-4, err_msg=f"plane {c}")
    # Uncovered pixels: every plane 0 (plane 1 = the combo constant).
    unc = (tt < 0)
    assert np.abs(tpl[:, unc]).max() == 0.0
    if not need_uv:
        for c in (2, 3, 4, *range(14, 24)):
            assert not tpl[c].any()


@pytest.mark.parametrize("need_uv,has_combo,tile_h,tile_w", [
    (True, True, 8, 128),
    (True, False, 16, 32),
    (False, False, 8, 128),
])
def test_plain_fused_matches_pallas_interpret(state, need_uv, has_combo,
                                              tile_h, tile_w):
    _assert_fused_close(*_run(state, need_uv, has_combo, tile_h, tile_w),
                        need_uv)


@pytest.mark.parametrize("tile_h,tile_w", [(8, 128), (16, 32)])
def test_plain_fused_matches_pallas_strip_skip(state, tile_h, tile_w):
    """The JAX kernel's own span skip (y_row, sub_rows=8) against the
    port's plain version, which tests every pair: the skip changes
    nothing beyond the file's tolerances."""
    _assert_fused_close(*_run(state, True, True, tile_h, tile_w, span=True),
                        True)


def test_port_fused_extra_matches_jax(state):
    cfg, jscene, jview, jworld, jn_world, jsetup, _ = state
    scene = scene_from_numpy(to_numpy_leaves(jscene), "cpu")
    view = view_from_numpy(to_numpy_leaves(jview), "cpu")
    world = t_apply_point(view.model, scene.pair_pos)
    n1 = t_apply_point(view.model, tpbr.normalize(scene.pair_nrm))
    n_world = tframe._mat_vec(scene.rot_table[scene.pair_rot.long()], n1)
    np.testing.assert_allclose(world.numpy(), np.asarray(jworld), atol=1e-6)
    np.testing.assert_allclose(n_world.numpy(), np.asarray(jn_world),
                               atol=1e-6)
    for need_uv, need_combo in ((True, True), (False, False)):
        want = jframe._fused_extra(jscene, jsetup, jworld, jn_world,
                                   need_uv=need_uv, need_combo=need_combo)
        got = tframe._fused_extra(scene, jsetup.edge.shape[0], world,
                                  n_world, need_uv=need_uv,
                                  need_combo=need_combo)
        assert got.shape[1] == tp.fused_extra_width(need_uv, need_combo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_fused_depth_and_ids_equal_the_unfused_plain_pass(state):
    """Phase 1 of the fused path is the visibility pass: equal bit for
    bit."""
    cfg, scene, view, world, n_world, setup, _ = state
    extra = jframe._fused_extra(scene, setup, world, n_world)
    ts = setup_from_numpy(to_numpy_leaves(setup), "cpu")
    pairs = tp.build_pairs(ts, W, H, 8, 128,
                           extra=torch.from_numpy(np.array(extra)),
                           sort_z=True, ysort_sub_rows=8)
    d0, t0 = tp.rasterize_pairs(pairs, H, W, tile_h=8, tile_w=128)
    d1, t1, _ = tp.rasterize_pairs_fused(pairs, H, W, tile_h=8, tile_w=128,
                                         texture_size=cfg.texture_size)
    np.testing.assert_array_equal(d0.numpy(), d1.numpy())
    np.testing.assert_array_equal(t0.numpy(), t1.numpy())
