"""Kernel ``pcf_taps``'s division-free wrap of the tap indices
(``wrap_tap_indices``) against ``torch.remainder``, maps 1-6 texels wide
(test_torch_pcf_wrap_wide.py: 7, 8 and 1,024)."""

import numpy as np
import pytest
import torch

from zeldaengine_tpu_torch.ops.pcf_cuda import wrap_tap_indices

torch.set_num_threads(1)


def check_wrap(n):
    """Kernel ``pcf_taps`` wraps only the first tap index of an axis with a
    remainder and every further one from it (``wrap_tap_indices``): equal
    to torch.remainder of every index, for maps narrower than the footprint
    too, and for coordinates whose conversion to int32 saturates (the CPU
    gives INT_MIN for both ends, so neighbouring taps can lie 2^32 apart)."""
    rng = np.random.default_rng(n)
    s = np.concatenate([
        rng.uniform(-1e9, 1e9, 2000), rng.uniform(-1e9, 1e9, 2000) / n,
        rng.uniform(-3.0, 3.0, 2000),
        np.array([2147483520.0, 2147483648.0, -2147483648.0, 3e9, -3e9,
                  1e12, -1e12]) / n]).astype(np.float32)
    f = torch.from_numpy(s) * float(n)
    for scale in (1.0, 1.5, 2.5):
        for radius in (1, 2, 3):
            o = torch.arange(-radius, radius + 1, dtype=torch.float32)
            idx = torch.floor(f[:, None] + scale * o[None, :]).to(torch.int32)
            want = torch.remainder(idx, n)
            np.testing.assert_array_equal(wrap_tap_indices(idx, n).numpy(),
                                          want.numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_division_free_wrap_equals_the_remainder(n):
    check_wrap(n)
