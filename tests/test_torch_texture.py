"""The port's texture samplers held against the JAX package's on the same
NumPy atlases: the mip-pair trilinear (one row fetch), the 2x2-packed and
quad-packed trilinear and the plain RGBA atlas (the cubemap is in
test_torch_texture_cube.py). uv spans [-2, 3] (repeat
addressing), lod spans [-1, mips + 1] (clamping). Every sampler is an
indexing gather with the JAX package's operation order, so the results
are held equal, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops import texture as jt
from zeldaengine_tpu_torch.ops import texture as tt

from _torch_texture_inputs import N_PX, _images, _taps, _bf16, _eq

torch.set_num_threads(1)


@pytest.mark.parametrize("size,c", [(16, 4), (32, 3), (8, 8)])
def test_trilinear_pair_matches_jax(size, c):
    """sample_trilinear_pair through sample_trilinear_packed (pair layout:
    the channel count is a multiple of 13), and the NumPy packer itself."""
    imgs = _images(size + c, 3, size, c)
    pair = tt.build_mip_pair_atlas(imgs)
    np.testing.assert_array_equal(pair, jt.build_mip_pair_atlas(imgs))
    ja, ta = _bf16(pair)
    layer, uv, lod = _taps(size, size, 3)
    want = jt.sample_trilinear_packed(ja, jnp.asarray(layer),
                                      jnp.asarray(uv), jnp.asarray(lod),
                                      size)
    got = tt.sample_trilinear_packed(ta, torch.from_numpy(layer),
                                     torch.from_numpy(uv),
                                     torch.from_numpy(lod), size)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N_PX, c)
    _eq(got, want)
    # A scalar layer broadcasts as the JAX package broadcasts it.
    _eq(tt.sample_trilinear_pair(ta, 1, torch.from_numpy(uv),
                                 torch.from_numpy(lod), size),
        jt.sample_trilinear_pair(ja, 1, jnp.asarray(uv), jnp.asarray(lod),
                                 size))


@pytest.mark.parametrize("quad", [False, True])
def test_packed_and_quad_trilinear_match_jax(quad):
    """The 2x2-packed (4C) and quad-packed (4 x 4C) layouts: two row
    fetches, one per level, blended."""
    size, c = 16, 4
    imgs = _images(7, 2, size, c)
    build = (tt.build_quad_packed_atlas if quad
             else tt.build_packed_mip_atlas)
    atlas = build(imgs)
    np.testing.assert_array_equal(
        atlas, (jt.build_quad_packed_atlas if quad
                else jt.build_packed_mip_atlas)(imgs))
    ja, ta = _bf16(atlas)
    layer, uv, lod = _taps(11, size, 2, shape=(64, 64))
    want = jt.sample_trilinear_packed(ja, jnp.asarray(layer),
                                      jnp.asarray(uv), jnp.asarray(lod),
                                      size, quad=quad)
    got = tt.sample_trilinear_packed(ta, torch.from_numpy(layer),
                                     torch.from_numpy(uv),
                                     torch.from_numpy(lod), size, quad=quad)
    _eq(got, want)


def test_plain_atlas_samplers_match_jax():
    """The plain (N, S, 2S, C) atlas: its packer, the bilinear tap at a
    per-pixel level (wrapping with the level's own size), the trilinear
    and sample_base, which no longer refuses it."""
    size = 32
    imgs = _images(13, 2, size, 4)
    atlas = tt.build_mip_atlas(imgs)
    np.testing.assert_array_equal(atlas, jt.build_mip_atlas(imgs))
    ja, ta = jnp.asarray(atlas), torch.from_numpy(atlas)
    layer, uv, lod = _taps(17, size, 2)
    level = np.clip(np.floor(lod), 0, tt.mip_count(size) + 1).astype(
        np.int32)
    args_j = (jnp.asarray(layer), jnp.asarray(uv))
    args_t = (torch.from_numpy(layer), torch.from_numpy(uv))
    _eq(tt.sample_bilinear_level(ta, *args_t, torch.from_numpy(level),
                                 size),
        jt.sample_bilinear_level(ja, *args_j, jnp.asarray(level), size))
    _eq(tt.sample_trilinear(ta, *args_t, torch.from_numpy(lod), size),
        jt.sample_trilinear(ja, *args_j, jnp.asarray(lod), size))
    _eq(tt.sample_base(ta, *args_t, size), jt.sample_base(ja, *args_j, size))
