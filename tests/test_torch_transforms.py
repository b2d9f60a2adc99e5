"""math/transforms of the port against the JAX package: camera, projection
and object matrices from the same inputs. (Instance matrices, matrix
application and colour are in test_torch_math.py.)"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.math import transforms as jt
from zeldaengine_tpu_torch.math import transforms as tt

torch.set_num_threads(1)

_RNG = np.random.default_rng(0)
_V3 = _RNG.normal(size=(3, 3)).astype(np.float32)
_Q = _RNG.normal(size=4).astype(np.float32)
_R = _RNG.normal(size=(7, 3)).astype(np.float32)
_M = _RNG.normal(size=(4, 4)).astype(np.float32)
_P = _RNG.normal(size=(5, 6, 3)).astype(np.float32)

_TRANSFORM_CASES = {
    "look_at": lambda m, c: m.look_at(c(_V3[0]), c(_V3[1]),
                                      c(np.float32([0, 0, 1]))),
    "perspective": lambda m, c: m.perspective(0.8, 1.5, 0.1, 45.0),
    "perspective_vk": lambda m, c: m.perspective_vk(0.8, 1.5, 0.1, 45.0),
    "rotate_z": lambda m, c: m.rotate_z(c(np.float32(0.7))),
    "quat_to_mat4": lambda m, c: m.quat_to_mat4(c(_Q)),
    "transform_matrix": lambda m, c: m.transform_matrix(
        c(_V3[0]), c(_Q / np.linalg.norm(_Q)), c(np.abs(_V3[1]))),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORM_CASES))
def test_transforms_match_jax(name):
    fn = _TRANSFORM_CASES[name]
    want = np.asarray(fn(jt, jnp.asarray))
    got = fn(tt, lambda a: torch.from_numpy(np.array(a))).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    # 1e-6 absolute and relative: a handful of fp32 operations.
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
