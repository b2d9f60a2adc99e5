"""Seeded images, atlases and taps shared by the texture sampler tests of
the port (tests/test_torch_texture*.py)."""

import jax.numpy as jnp
import numpy as np
import torch

from zeldaengine_tpu_torch.ops import texture as tt


N_PX = 4096


def _images(seed, n, size, c):
    return np.random.default_rng(seed).random((n, size, size, c)).astype(
        np.float32)


def _taps(seed, size, n_layers, shape=(N_PX,)):
    """(layer, uv, lod) over the ranges the samplers must wrap and clamp;
    a few lods sit exactly on integers."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.0, 3.0, shape + (2,)).astype(np.float32)
    lod = rng.uniform(-1.0, tt.mip_count(size) + 1.0, shape).astype(
        np.float32)
    lod[:64] = np.round(lod[:64])
    layer = rng.integers(0, n_layers, shape).astype(np.int32)
    return layer, uv, lod


def _bf16(a):
    """The same bf16 atlas for both packages."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(
        tt.round_bf16(a)).to(torch.bfloat16)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
