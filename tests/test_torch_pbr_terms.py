"""``ops/pbr.py`` of the port against the JAX package on the same seeded
inputs: Fresnel, diffuse, visibility, distribution and occlusion terms. Tolerance atol 1e-5 / rtol 2e-5: the same fp32 formulas
evaluated by two compilers."""

import pytest
import torch

from _torch_pbr_cases import PBR_CASES, check_pbr_case

torch.set_num_threads(1)

NAMES = ['pow5', 'f_schlick', 'fr_disney_diffuse', 'v_smith_ggx_correlated', 'd_ggx', 'env_brdf_approx', 'specular_occlusion']


@pytest.mark.parametrize("name", NAMES)
def test_pbr_matches_jax(name):
    assert name in PBR_CASES
    check_pbr_case(name)
