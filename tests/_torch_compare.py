"""Helpers shared by the tests of the PyTorch/CUDA port: carry JAX state
across as NumPy, and the whole-frame criterion of tests/test_golden.py."""

import numpy as np


def to_numpy_leaves(tup) -> dict:
    """NamedTuple of JAX/NumPy leaves -> dict of NumPy arrays (bfloat16 as
    float32, which is exact; None stays None)."""
    out = {}
    for name, leaf in tup._asdict().items():
        if leaf is None:
            out[name] = None
            continue
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        out[name] = a
    return out


def assert_golden(got, want, what="frame"):
    """tests/test_golden.py:97-102: fewer than 1 % of pixels off by more
    than 4/255 and median difference <= 1/255. pack_gbuffer quantises, so
    one ulp upstream can become a 1/255 step: whole frames are never held
    to allclose."""
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    frac = float((diff > 4 / 255).mean())
    assert frac < 0.01, f"{what}: {frac:.4f} of values off by > 4/255"
    assert float(np.median(diff)) <= 1 / 255, f"{what}: median {np.median(diff)}"
    return frac
