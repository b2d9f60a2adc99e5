"""test_torch_pcf_wrap.py's wrap check on maps 7, 8 and 1,024 texels
wide."""

import pytest

from test_torch_pcf_wrap import check_wrap


@pytest.mark.parametrize("n", [7, 8, 1024])
def test_division_free_wrap_equals_the_remainder(n):
    check_wrap(n)
