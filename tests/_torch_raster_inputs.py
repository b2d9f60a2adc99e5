"""Seeded triangle inputs shared by the rasterizer tests of the port: the
same clip-space triangles set up by the JAX package and by the port."""

import numpy as np
import jax.numpy as jnp
import torch

from zeldaengine_tpu.ops import rasterize as jr
from zeldaengine_tpu_torch.ops import rasterize as tr

H, W = 64, 128


def random_clip(seed, n=300):
    # Clip-space triangles with positive w, spread over the viewport.
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.0, 1.0, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-0.15, 0.15, (n, 3, 3)).astype(np.float32)
    pos = centers + offs
    w = rng.uniform(0.5, 3.0, (n, 3, 1)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).astype(np.float32) * w
    clip = np.concatenate([pos[..., :2] * w, z * np.ones((1, 3, 1)), w], -1)
    # A few big triangles (supertile / global bucket) and one behind the
    # camera.
    clip[:4, :, :2] *= 6.0
    clip[4, :, 3] = -1.0
    return clip.astype(np.float32)


def setups(seed, n=300, **kw):
    clip = random_clip(seed, n)
    two = np.random.default_rng(seed + 1).random(n) < 0.5
    valid = np.random.default_rng(seed + 2).random(n) < 0.9
    js = jr.triangle_setup(jnp.asarray(clip), W, H,
                           two_sided=jnp.asarray(two),
                           valid_mask=jnp.asarray(valid), **kw)
    ts = tr.triangle_setup(torch.from_numpy(clip), W, H,
                           two_sided=torch.from_numpy(two),
                           valid_mask=torch.from_numpy(valid), **kw)
    return js, ts
