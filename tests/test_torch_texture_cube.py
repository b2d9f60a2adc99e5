"""The port's cubemap sampler at a per-pixel lod (textureLod(samplerCube))
held against the JAX package's on the same NumPy atlases in the pair, quad
and plain layouts, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops import texture as jt
from zeldaengine_tpu_torch.ops import texture as tt

from _torch_texture_inputs import N_PX, _images, _taps, _bf16, _eq

torch.set_num_threads(1)


@pytest.mark.parametrize("layout", ["pair", "quad", "plain"])
def test_cubemap_lod_matches_jax(layout):
    """textureLod(samplerCube): face selection, the half-texel clamp of the
    lod's level, then the layout's trilinear; two cubemaps (12 layers)."""
    size = 16
    faces = _images(3, 12, size, 4)
    atlas = {"pair": tt.build_mip_pair_atlas, "quad":
             tt.build_quad_packed_atlas, "plain": tt.build_mip_atlas}[
        layout](faces)
    if layout == "plain":
        ja, ta = jnp.asarray(atlas), torch.from_numpy(atlas)
    else:
        ja, ta = _bf16(atlas)
    rng = np.random.default_rng(5)
    d = rng.standard_normal((N_PX, 3)).astype(np.float32)
    # The six axes exactly (ties of the face selection).
    d[:6] = np.eye(3, dtype=np.float32).repeat(2, 0) * np.float32(
        [1, -1, 1, -1, 1, -1])[:, None]
    cube = rng.integers(0, 2, N_PX).astype(np.int32)
    _, _, lod = _taps(9, size, 1)
    quad = layout == "quad"
    want = jt.sample_cubemap_lod(ja, jnp.asarray(cube), jnp.asarray(d),
                                 jnp.asarray(lod), size, quad=quad)
    got = tt.sample_cubemap_lod(ta, torch.from_numpy(cube),
                                torch.from_numpy(d), torch.from_numpy(lod),
                                size, quad=quad)
    _eq(got, want)
