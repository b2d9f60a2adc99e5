"""Port of the rasterizer held against the JAX package on the same NumPy
inputs: triangle_setup and the brute-force rasterizers. (build_pairs is in
test_torch_build_pairs.py, the pair rasterizer in
test_torch_pair_raster.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops import rasterize as jr
from zeldaengine_tpu_torch.convert import setup_from_numpy
from zeldaengine_tpu_torch.math.transforms import fma_f32, fma_f32_plain
from zeldaengine_tpu_torch.ops import rasterize as tr

from _torch_compare import to_numpy_leaves
from _torch_raster_inputs import H, W, random_clip as _random_clip
from _torch_raster_inputs import setups as _setups

torch.set_num_threads(1)

def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("depth_bias", [None, (1.25, 7.5)])
def test_triangle_setup_matches_jax(depth_bias, seed):
    """Bit for bit against the JAX package's triangle_setup as it runs in
    its compiled frame (jitted, on the CPU): XLA fuses the adjugate's
    minors, the determinant, the depth-bias slope (a multiply-add chain
    whose cancellation makes its order part of the result), the bias and
    the biased depth coefficients into fused multiply-adds, and the port
    computes each in that form (``math/transforms.py::fma_f32``)."""
    clip = _random_clip(seed)
    two = np.random.default_rng(seed + 1).random(clip.shape[0]) < 0.5
    valid = np.random.default_rng(seed + 2).random(clip.shape[0]) < 0.9
    setup = jax.jit(lambda c, t, v: jr.triangle_setup(
        c, W, H, two_sided=t, valid_mask=v, depth_bias=depth_bias))
    js = setup(jnp.asarray(clip), jnp.asarray(two), jnp.asarray(valid))
    ts = tr.triangle_setup(torch.from_numpy(clip), W, H,
                           two_sided=torch.from_numpy(two),
                           valid_mask=torch.from_numpy(valid),
                           depth_bias=depth_bias)
    for name in ("edge", "zc", "valid", "bbox", "zmin"):
        np.testing.assert_array_equal(
            _bits(getattr(ts, name).numpy()), _bits(getattr(js, name)),
            err_msg=name)
    if depth_bias is not None:
        # The bias moved depth: the term itself is not zero.
        unbiased = tr.triangle_setup(torch.from_numpy(clip), W, H,
                                     two_sided=torch.from_numpy(two),
                                     valid_mask=torch.from_numpy(valid))
        assert not torch.equal(unbiased.zc, ts.zc)


def test_fma_f32_rounds_once():
    """``fma_f32`` (its plain version, ``fma_f32_plain``, on CPU tensors;
    kernel ``fma`` on the card) against exact rational arithmetic: one
    rounding, also where a plain fp64 sum would round twice (the first
    case: the fp64 sum lands on an fp32 midpoint, which ties to even, a
    step above the correctly rounded result)."""
    from fractions import Fraction

    f32 = np.float32
    a = [f32(1 + 2.0 ** -23)]
    b = [f32(2.0 ** -24 * (1 - 2.0 ** -23))]
    c = [f32(1 + 2.0 ** -23)]
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-4, 1e4):
        a += list(rng.standard_normal(2000).astype(f32))
        b += list((rng.standard_normal(2000) * scale).astype(f32))
        c += list((rng.standard_normal(2000) * scale).astype(f32))
    a, b, c = (np.array(x, f32) for x in (a, b, c))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    # CPU tensors take the plain version; the kernel needs the card.
    np.testing.assert_array_equal(got, fma_f32_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)))
    with pytest.raises(RuntimeError, match="card"):
        fma_f32(torch.from_numpy(a), 2.0, 1.0, backend="cuda")
    assert fma_f32.launches == 0
    naive = (a.astype(np.float64) * b + c).astype(f32)
    assert got[0] == f32(1 + 2.0 ** -23) and naive[0] != got[0]
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = f32(float(exact))     # nearest fp64, then its fp32 neighbours
        cands = {lo, np.nextafter(lo, f32(np.inf)),
                 np.nextafter(lo, f32(-np.inf))}
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.uint32))
                                         & 1))
        assert g == best, (x, y, z, g, best)


def test_reference_cpu_depth_is_the_fma_contracted_form():
    """On the CPU, XLA fuses ``_coverage_chunk`` and contracts its
    multiply-adds. Evaluated in NumPy on the same setup, exactly one
    contraction pattern reproduces the JAX depth bit for bit at every
    covered pixel: e_i = fma(a_i, px, b_i*py) + c_i, depth = fma(e2, z2,
    fma(e0, z0, e1*z1)); the same formula with every product and sum
    rounded separately equals it at fewer than half of them. The port
    evaluates the contracted form (``ops/rasterize.py::edge_value``,
    ``plane_depth``; its kernels with ``__fmaf_rn``)."""
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
    # ... and the contracted form is what the port computes.
    td, _ = tr.rasterize_visibility(setup_from_numpy(to_numpy_leaves(js),
                                                     "cpu"), H, W, chunk=64)
    np.testing.assert_array_equal(td.numpy()[cov], jd[cov])


@pytest.mark.parametrize("chunk", [64])
def test_brute_force_rasterizers_match_jax(chunk):
    js, _ = _setups(3, n=120)
    ts = setup_from_numpy(to_numpy_leaves(js), "cpu")
    jd, jt = jr.rasterize_visibility(js, H, W, chunk=chunk)
    td, tt = tr.rasterize_visibility(ts, H, W, chunk=chunk)
    # Depth bit for bit: both evaluate the contracted form (test above).
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (tt.numpy() != np.asarray(jt)).mean() < 0.01
    np.testing.assert_array_equal(
        tr.rasterize_depth(ts, H, W, chunk=chunk).numpy(),
        np.asarray(jr.rasterize_depth(js, H, W, chunk=chunk)))
    jb, jc = jr.interpolation_coeffs(js, jt, H, W)
    tb, tc = tr.interpolation_coeffs(ts, torch.from_numpy(np.array(jt)),
                                     H, W)
    cov = np.asarray(jc)
    np.testing.assert_array_equal(tc.numpy(), cov)
    np.testing.assert_allclose(tb.numpy()[cov], np.asarray(jb)[cov],
                               atol=2e-5)
