"""``ops/pbr.py`` of the port against the JAX package on the same seeded
inputs: the lit BxDF, F0, reflection mip and the vector helpers. Tolerance atol 1e-5 / rtol 2e-5: the same fp32 formulas
evaluated by two compilers."""

import pytest
import torch

from _torch_pbr_cases import PBR_CASES, check_pbr_case

torch.set_num_threads(1)

NAMES = ['reflection_mip', 'compute_f0', 'default_lit_bxdf_d', 'default_lit_bxdf_s', 'refract', 'normalize', 'tangent_normal']


@pytest.mark.parametrize("name", NAMES)
def test_pbr_matches_jax(name):
    assert name in PBR_CASES
    check_pbr_case(name)
