"""Port of the rasterizer held against the JAX package on the same NumPy
inputs: triangle_setup and the brute-force rasterizers. (build_pairs is in
test_torch_build_pairs.py, the pair rasterizer in
test_torch_pair_raster.py.)"""

import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops import rasterize as jr
from zeldaengine_tpu_torch.convert import setup_from_numpy
from zeldaengine_tpu_torch.ops import rasterize as tr

from _torch_compare import to_numpy_leaves
from _torch_raster_inputs import H, W, setups as _setups

torch.set_num_threads(1)

@pytest.mark.parametrize("depth_bias", [None, (1.25, 7.5)])
def test_triangle_setup_matches_jax(depth_bias):
    js, ts = _setups(0, depth_bias=depth_bias)
    np.testing.assert_array_equal(np.asarray(js.valid), ts.valid.numpy())
    for name in ("edge", "bbox", "zmin"):
        # 1e-6: the same fp32 formulas; XLA may contract multiply-adds.
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            atol=1e-6, rtol=1e-6, err_msg=name)
    # zc = z / det is large where det is small: relative 2e-6. With the
    # depth bias, zc also carries slope = max_j |sum_i zc_i * edge[i, j]|,
    # a sum that cancels (zc ~ 1/det, the gradient is small): the port adds
    # it in plain fp32 index order, XLA contracts it into multiply-adds,
    # and the biased zc then differs by up to 4.5e-6 relative on this
    # input. Held to 1e-5.
    rtol = 2e-6 if depth_bias is None else 1e-5
    np.testing.assert_allclose(ts.zc.numpy(), np.asarray(js.zc),
                               rtol=rtol, atol=1e-6)


def test_reference_cpu_depth_is_the_fma_contracted_form():
    """Why depths are held to 5e-5 and not to equality: on the CPU, XLA
    fuses ``_coverage_chunk`` and contracts its multiply-adds. Evaluated in
    NumPy on the same setup, exactly one contraction pattern reproduces
    the JAX depth bit for bit at every covered pixel:
    e_i = fma(a_i, px, b_i*py) + c_i, depth = fma(e2, z2, fma(e0, z0,
    e1*z1)); the same formula with every product and sum rounded
    separately (what the port computes, in its plain versions and in its
    kernels) equals it at fewer than half of them."""
    js, _ = _setups(3, n=120)
    jd, jt = jr.rasterize_visibility(js, H, W, chunk=64)
    jd, jt = np.asarray(jd), np.asarray(jt)
    cov = jt >= 0
    assert cov.mean() > 0.05
    t = np.maximum(jt, 0)
    edge, zc = np.asarray(js.edge)[t], np.asarray(js.zc)[t]   # (H, W, 3, ..)
    py, px = np.meshgrid(np.arange(H, dtype=np.float32) + 0.5,
                         np.arange(W, dtype=np.float32) + 0.5, indexing="ij")
    f32, f64 = np.float32, np.float64

    def fma(a, b, c):  # one rounding (the f32 product is exact in f64)
        return (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(f32)

    a, b, c = (edge[..., j] for j in range(3))                # (H, W, 3)
    e_fma = fma(a, px[..., None], b * py[..., None]) + c
    d_fma = fma(e_fma[..., 2], zc[..., 2],
                fma(e_fma[..., 0], zc[..., 0], e_fma[..., 1] * zc[..., 1]))
    e_sep = a * px[..., None] + b * py[..., None] + c
    d_sep = (e_sep[..., 0] * zc[..., 0] + e_sep[..., 1] * zc[..., 1]
             + e_sep[..., 2] * zc[..., 2])
    assert d_sep.dtype == f32
    np.testing.assert_array_equal(d_fma[cov], jd[cov])
    assert (d_sep[cov] == jd[cov]).mean() < 0.5
    # ... and the separately rounded form is what the port computes.
    td, _ = tr.rasterize_visibility(setup_from_numpy(to_numpy_leaves(js),
                                                     "cpu"), H, W, chunk=64)
    np.testing.assert_array_equal(td.numpy()[cov], d_sep[cov])


@pytest.mark.parametrize("chunk", [64])
def test_brute_force_rasterizers_match_jax(chunk):
    js, _ = _setups(3, n=120)
    ts = setup_from_numpy(to_numpy_leaves(js), "cpu")
    jd, jt = jr.rasterize_visibility(js, H, W, chunk=chunk)
    td, tt = tr.rasterize_visibility(ts, H, W, chunk=chunk)
    # 5e-5: depth of both is sum e_i * zc_i in fp32, XLA contracts FMAs.
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=5e-5)
    assert (tt.numpy() != np.asarray(jt)).mean() < 0.01
    np.testing.assert_allclose(
        tr.rasterize_depth(ts, H, W, chunk=chunk).numpy(),
        np.asarray(jr.rasterize_depth(js, H, W, chunk=chunk)), atol=5e-5)
    jb, jc = jr.interpolation_coeffs(js, jt, H, W)
    tb, tc = tr.interpolation_coeffs(ts, torch.from_numpy(np.array(jt)),
                                     H, W)
    cov = np.asarray(jc)
    np.testing.assert_array_equal(tc.numpy(), cov)
    np.testing.assert_allclose(tb.numpy()[cov], np.asarray(jb)[cov],
                               atol=2e-5)
