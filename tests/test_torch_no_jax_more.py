"""test_torch_no_jax.py's import scan over the remaining source directories
of the port (the sorted groups after its first ones): they import neither
JAX nor the JAX package."""

import pytest

from _torch_sources import FIRST_GROUPS, assert_imports_no_jax, groups


@pytest.mark.parametrize("group", sorted(groups())[FIRST_GROUPS:])
def test_source_imports_no_jax(group):
    assert_imports_no_jax(group)
