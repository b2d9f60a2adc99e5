"""``build_pairs`` of the port against the JAX package on the same
triangles: bins, pair order, records and the overflow count are equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.ops import rasterize_pallas as jp
from zeldaengine_tpu_torch.convert import pairs_from_numpy, setup_from_numpy
from zeldaengine_tpu_torch.ops import rasterize_cuda as tp

from _torch_compare import to_numpy_leaves
from _torch_raster_inputs import (
    H, W, setups as _setups)

torch.set_num_threads(1)


_BIN_CASES = [
    # tile_h, tile_w, expand, sort_z, ysort, max_pairs, center_cull
    (8, 128, 8, False, None, None, False),
    (8, 128, 2, False, None, None, False),
    (16, 32, 8, True, None, None, False),
    (16, 32, 2, True, 8, None, False),
    (64, 32, 8, True, 8, None, False),
    (64, 32, 4, True, 8, 256, False),
    (8, 128, 8, True, 8, 128, True),
]


@pytest.mark.parametrize(
    "tile_h,tile_w,expand,sort_z,ysort,max_pairs,center_cull", _BIN_CASES)
def test_build_pairs_equal_to_jax(tile_h, tile_w, expand, sort_z, ysort,
                                  max_pairs, center_cull):
    """Bins, pair order and the overflow count are EQUAL (integers), the
    records equal bit for bit: same int32 key bit budget, stable sort."""
    js, _ = _setups(5)
    ts = setup_from_numpy(to_numpy_leaves(js), "cpu")
    extra = np.random.default_rng(9).random((300, 5)).astype(np.float32)
    kw = dict(expand=expand, sort_z=sort_z, ysort_sub_rows=ysort,
              max_pairs=max_pairs, center_cull=center_cull)
    jpairs = jp.build_pairs(js, W, H, tile_h, tile_w,
                            extra=jnp.asarray(extra), **kw)
    tpairs = tp.build_pairs(ts, W, H, tile_h, tile_w,
                            extra=torch.from_numpy(extra), **kw)
    carried = pairs_from_numpy(to_numpy_leaves(jpairs), "cpu")
    for name in ("starts", "ends", "sstarts", "sends", "gbounds",
                 "pair_tri"):
        np.testing.assert_array_equal(
            getattr(tpairs, name).numpy(), getattr(carried, name).numpy(),
            err_msg=name)
    assert int(tpairs.overflow) == int(jpairs.overflow)
    np.testing.assert_array_equal(tpairs.records.numpy(),
                                  carried.records.numpy())
    if max_pairs is not None:
        assert int(tpairs.overflow) > 0
