"""math/ of the port against the JAX package: instance rotation matrices,
matrix application to points, and colour. (Camera and object matrices are
in test_torch_transforms.py.)"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.math import color as jcolor, transforms as jt
from zeldaengine_tpu_torch.math import color as tcolor, transforms as tt

torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
_V3 = _RNG.normal(size=(3, 3)).astype(np.float32)
_Q = _RNG.normal(size=4).astype(np.float32)
_R = _RNG.normal(size=(7, 3)).astype(np.float32)
_M = _RNG.normal(size=(4, 4)).astype(np.float32)
_P = _RNG.normal(size=(5, 6, 3)).astype(np.float32)

_TRANSFORM_CASES = {
    "make_rot_matrix": lambda m, c: m.make_rot_matrix(c(_R)),
    "euler_instance_matrix": lambda m, c: m.euler_instance_matrix(c(_R)),
    "apply_mat4_point": lambda m, c: m.apply_mat4_point(c(_M), c(_P)),
    "apply_mat4_h": lambda m, c: m.apply_mat4_h(c(_M), c(_P)),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORM_CASES))
def test_transforms_match_jax(name):
    fn = _TRANSFORM_CASES[name]
    want = np.asarray(fn(jt, jnp.asarray))
    got = fn(tt, lambda a: torch.from_numpy(np.array(a))).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    # 1e-6 absolute and relative: a handful of fp32 operations.
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["hue2rgb", "gamma_correct",
                                  "srgb_to_linear"])
def test_color_matches_jax(name):
    x = np.random.default_rng(1).random((9, 3)).astype(np.float32) * 1.5
    want = np.asarray(getattr(jcolor, name)(jnp.asarray(x)))
    got = getattr(tcolor, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2e-6)
