"""Plain version of kernel pcf_taps (the port of compute_pcf) against the
JAX package's compute_pcf and against its Pallas PCF kernel in interpret
mode. The CUDA kernel itself is held against this plain version on the
card by chip_smoke.py. Its wrap of the tap indices is in
test_torch_pcf_wrap.py and test_torch_pcf_wrap_wide.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.ops.pcf_vmem import compute_pcf_vmem as j_pcf_vmem
from zeldaengine_tpu.ops.shadow import (
    compute_pcf as j_pcf, compute_shadow_coord as j_coord)
from zeldaengine_tpu_torch.ops.pcf_cuda import (
    compute_pcf_plain, compute_pcf_vmem)
from zeldaengine_tpu_torch.ops.shadow import (
    _shadow_tap, compute_pcf, compute_shadow_coord)

torch.set_num_threads(1)


def _assert_taps_equal(out, ref, count=25.0):
    out, ref = np.asarray(out), np.asarray(ref)
    # total = count - 0.9 * k  =>  k recovers the exact tap classification
    k_out = np.round((count - out * count) / 0.9)
    k_ref = np.round((count - ref * count) / 0.9)
    np.testing.assert_array_equal(k_out, k_ref)
    # 2e-7: one ulp of the averaged factor (tests/test_pcf_vmem.py).
    np.testing.assert_allclose(out, ref, atol=2e-7, rtol=0)


def _smooth(rng, h, w, du=0.00035, dv=0.0003, skew=0.00008):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = (0.15 + du * xx + skew * yy).astype(np.float32)
    v = (0.21 + dv * yy - 0.6 * skew * xx).astype(np.float32)
    z = (0.4 + 0.0001 * yy + 0.2 * rng.random((h, w))).astype(np.float32)
    return np.stack([u, v, z, np.ones((h, w), np.float32)], -1)


def _wild(rng, h, w):
    # Wrap regions (u, v outside [0, 1], negative), huge footprints.
    u = rng.random((h, w)).astype(np.float32) * 4.0 - 1.5
    v = rng.random((h, w)).astype(np.float32) * 4.0 - 1.5
    z = rng.random((h, w)).astype(np.float32)
    return np.stack([u, v, z, np.ones((h, w), np.float32)], -1)


@pytest.mark.parametrize("kind,dim,h,w", [
    ("wild", 128, 16, 256), ("smooth", 256, 30, 200)])
def test_plain_matches_jax_exact_and_vmem_kernel(kind, dim, h, w):
    rng = np.random.default_rng(20260817)
    sm = rng.random((dim, dim)).astype(np.float32)
    sc = (_smooth if kind == "smooth" else _wild)(rng, h, w)
    # homogeneous coordinate with w != 1, and an out-of-range band
    sc = sc * np.float32(1.7)
    sc[:3, :, 2] = 1.5 * sc[:3, :, 3]
    sc[3, :, 3] = -1.0
    want = j_pcf(jnp.asarray(sm), jnp.asarray(sc))
    got = compute_pcf(torch.from_numpy(sm), torch.from_numpy(sc))
    _assert_taps_equal(got.numpy(), want)
    kern, ovf = j_pcf_vmem(jnp.asarray(sm), jnp.asarray(sc), interpret=True)
    assert int(ovf) == 0
    out, overflow = compute_pcf_vmem(torch.from_numpy(sm),
                                     torch.from_numpy(sc))
    assert overflow == 0
    _assert_taps_equal(out.numpy(), kern)
    assert np.all(out.numpy()[:4] == 1.0)  # out of range reads 1.0


def test_active_mask_does_not_change_the_output():
    rng = np.random.default_rng(5)
    sm = torch.from_numpy(rng.random((128, 128)).astype(np.float32))
    sc = torch.from_numpy(_smooth(rng, 16, 128))
    active = torch.from_numpy(rng.random((16, 128)) < 0.5)
    a, _ = compute_pcf_vmem(sm, sc, active=active)
    b, _ = compute_pcf_vmem(sm, sc)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert compute_pcf_plain is compute_pcf


@pytest.mark.parametrize("radius,scale,bias", [(1, 1.5, 0.0), (2, 1.0, 0.01)])
def test_plain_other_radius_scale_bias(radius, scale, bias):
    rng = np.random.default_rng(6)
    sm = rng.random((128, 128)).astype(np.float32)
    sc = _wild(rng, 8, 128)
    want = j_pcf(jnp.asarray(sm), jnp.asarray(sc), radius=radius,
                 scale=scale, bias=bias)
    got = compute_pcf(torch.from_numpy(sm), torch.from_numpy(sc),
                      radius=radius, scale=scale, bias=bias)
    _assert_taps_equal(got.numpy(), want, count=float((2 * radius + 1) ** 2))


def test_shadow_coord_and_single_tap_match_jax():
    rng = np.random.default_rng(7)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    p = rng.normal(size=(9, 11, 3)).astype(np.float32)
    want = j_coord(jnp.asarray(m), jnp.asarray(p))
    got = compute_shadow_coord(torch.from_numpy(m), torch.from_numpy(p))
    # 1e-6 relative to O(1) values: four fp32 multiply-adds.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    sm = rng.random((64, 64)).astype(np.float32)
    sc = _wild(rng, 8, 16)
    from zeldaengine_tpu.ops.shadow import _shadow_tap as j_tap

    np.testing.assert_array_equal(
        _shadow_tap(torch.from_numpy(sm), torch.from_numpy(sc), 0.01,
                    -0.02).numpy(),
        np.asarray(j_tap(jnp.asarray(sm), jnp.asarray(sc), 0.01, -0.02)))


def test_wrapper_refuses_cpu_tensors_for_the_cuda_backend():
    sm = torch.zeros((64, 64))
    sc = torch.zeros((4, 4, 4))
    with pytest.raises(RuntimeError, match="card"):
        compute_pcf_vmem(sm, sc, backend="cuda")
    assert compute_pcf_vmem.launches == 0
