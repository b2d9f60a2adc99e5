"""The PCF backends that the JAX package wrote as plain array code, without
a TPU kernel (``pcf_backend`` "packed_y4"/"packed_y8", "packed4"/"8"/"16",
"window1", "half_y4"), and the scene build's caches: the atlas cache (the
device-resident LRU), the device atlas builders and the native Morton
sort.

The filters run on seeded random maps and coordinates against the JAX
functions run op by op, at the JAX package's own tolerance for each
(tests/test_shadow.py): tap for tap for the exact ones (bit for bit, and
equal to ``compute_pcf``), its smooth-field bound for the half-resolution
one. Jitted, XLA divides the tap sum by multiplying with the reciprocal:
there the factors lie within one ulp."""

import numpy as np
import jax
import pytest
import torch

import zeldaengine_tpu.native as j_native
from zeldaengine_tpu.ops import shadow as js
from zeldaengine_tpu_torch import TEST_CONFIG, native
from zeldaengine_tpu_torch.ops import shadow as ts
from zeldaengine_tpu_torch.ops import texture as tt
from zeldaengine_tpu_torch.scene import SceneBuilder, make_cube, make_sphere
from zeldaengine_tpu_torch.scene import scenebuild as sb

torch.set_num_threads(1)


def _inputs(seed, dim, h=30, w=34):
    """A random map and homogeneous coordinates reaching past every edge
    (wrap), out of depth range and behind the light (w <= 0 excluded from
    the bias matrix's divide)."""
    rng = np.random.default_rng(seed)
    sm = rng.random((dim, dim)).astype(np.float32)
    sc = np.concatenate([rng.uniform(-0.3, 1.3, (h, w, 2)),
                         rng.uniform(-1.2, 1.2, (h, w, 1)),
                         rng.uniform(0.2, 2.0, (h, w, 1))], -1)
    sc[..., :2] *= sc[..., 3:]
    return sm, sc.astype(np.float32)


# variant -> [(JAX function, port function, keyword arguments), ...]
_VARIANTS = {
    "packed_y": [(js.compute_pcf_packed_y, ts.compute_pcf_packed_y,
                  dict(ygroup=g)) for g in (4, 8)],
    "packed4": [(js.compute_pcf_packed4, ts.compute_pcf_packed4,
                 dict(group=g)) for g in (2, 4, 8, 16)],
    "window1": [(js.compute_pcf_window1, ts.compute_pcf_window1, kw)
                for kw in ({}, dict(radius=1, scale=2.5),
                           dict(radius=3, scale=1.0))],
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_exact_variant_matches_jax_tap_for_tap(variant):
    for seed, dim in ((1, 64), (2, 40)):
        sm, sc = _inputs(seed, dim)
        tsm, tsc = torch.from_numpy(sm), torch.from_numpy(sc)
        for jf, tf, kw in _VARIANTS[variant]:
            kw = dict(kw, bias=0.01)
            want = np.asarray(jf(sm, sc, **kw))
            got = tf(tsm, tsc, **kw).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str(kw))
            taps = {k: v for k, v in kw.items()
                    if k in ("radius", "scale", "bias")}
            exact = ts.compute_pcf(tsm, tsc, **taps).numpy()
            np.testing.assert_array_equal(got, exact, err_msg=str(kw))
            jitted = np.asarray(jax.jit(lambda m, c: jf(m, c, **kw))(sm, sc))
            np.testing.assert_allclose(got, jitted, atol=1.2e-7, rtol=0)
            assert 0.099 < got.min() < got.max() <= 1.0


def test_half_y4_matches_jax_and_the_half_bound():
    """``compute_pcf_half(inner="packed_y")`` ("half_y4"): bit for bit with
    the JAX function on random inputs, and on the smooth field of
    tests/test_shadow.py:277 within its bound of the exact filter (under a
    quarter of pixels off by more than two tap quanta, mean under 0.03);
    odd shapes take the full-resolution filter."""
    sm, sc = _inputs(3, 64, 30, 34)
    for up in ("linear", "nearest"):
        want = np.asarray(js.compute_pcf_half(sm, sc, bias=0.01, upsample=up,
                                              inner="packed_y"))
        got = ts.compute_pcf_half(torch.from_numpy(sm), torch.from_numpy(sc),
                                  bias=0.01, upsample=up, inner="packed_y")
        np.testing.assert_array_equal(got.numpy(), want)
    dim = 128
    ty, tx = np.mgrid[0:dim, 0:dim].astype(np.float32) / dim
    smooth = (0.6 + 0.3 * ty).astype(np.float32)
    smooth[30:80, 40:90] = 0.35
    h, w = 32, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = 0.2 + xx / w * 0.6 + 0.03 * np.sin(yy / 7.0)
    v = 0.2 + yy / h * 0.6
    z = 0.4 + 0.2 * (xx / w)
    coord = torch.from_numpy(np.stack([u, v, z, np.ones_like(u)], -1))
    exact = ts.compute_pcf(torch.from_numpy(smooth), coord).numpy()
    for up in ("linear", "nearest"):
        half = ts.compute_pcf_half(torch.from_numpy(smooth), coord,
                                   upsample=up, inner="packed_y").numpy()
        assert half.shape == exact.shape
        assert np.mean(np.abs(half - exact) > 2 * 0.037) < 0.25, up
        assert np.mean(np.abs(half - exact)) < 0.03, up
    tsm, odd_sc = torch.from_numpy(sm), torch.from_numpy(sc[:, :33])
    odd = ts.compute_pcf_half(tsm, odd_sc, inner="packed_y")
    np.testing.assert_array_equal(
        odd.numpy(), ts.compute_pcf_packed(tsm, odd_sc).numpy())


def _builder(seed=0):
    b = SceneBuilder(TEST_CONFIG)
    rng = np.random.default_rng(seed)
    tex = rng.random((TEST_CONFIG.texture_size,) * 2 + (4,)).astype(
        np.float32)
    mat = b.add_material({0: tex})
    b.add_object(make_cube(1.0), mat, deferred=True)
    b.add_object(make_sphere(0.5, 8, 12), b.add_material({}), deferred=True)
    sky = rng.random((TEST_CONFIG.background_size,) * 2 + (4,)).astype(
        np.float32)
    b.set_skydome_texture(sky)
    return b


_ATLASES = ("combined_atlas", "cube_atlas", "cube_pair1", "sky_tex",
            "bg_tex", "sky_planes", "bg_planes")


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_atlas_cache_tiers(monkeypatch):
    """A second build of the same content takes every atlas from the
    device cache (the same tensors, nothing packed); with the cache
    emptied the packers run again and give the same bytes, bf16 atlases
    included (the cache changes no byte); other content misses; the cache
    keeps at most ``DEVICE_ATLAS_ENTRIES`` atlases."""
    monkeypatch.setattr(sb, "_DEVICE_ATLAS_CACHE", {})
    first, _ = _builder().build(device="cpu")
    packers = ("build_mip_pair_atlas", "build_mip_pair_atlas_host",
               "build_quad_packed_atlas_host")
    saved = {name: getattr(tt, name) for name in packers}

    def no_packing(*args, **kw):
        raise AssertionError("an atlas was packed: the device cache missed")

    for name in packers:  # the device cache alone must serve
        monkeypatch.setattr(tt, name, no_packing)
    second, _ = _builder().build(device="cpu")
    for name, fn in saved.items():
        monkeypatch.setattr(tt, name, fn)
    for name in _ATLASES:
        assert getattr(second, name) is getattr(first, name), name
    sb._DEVICE_ATLAS_CACHE.clear()
    third, _ = _builder().build(device="cpu")
    for name in _ATLASES:
        a, b = getattr(first, name), getattr(third, name)
        assert a is not b and a.dtype == b.dtype, name
        assert torch.equal(_bits(a), _bits(b)), name
    assert first.combined_atlas.dtype == torch.bfloat16
    other, _ = _builder(seed=1).build(device="cpu")
    assert not torch.equal(_bits(other.combined_atlas),
                           _bits(first.combined_atlas))
    assert len(sb._DEVICE_ATLAS_CACHE) <= sb.DEVICE_ATLAS_ENTRIES


def test_device_atlas_builders_and_the_native_morton_sort():
    """The device atlas builders equal the host builders (bf16 and f32);
    ``morton_sort_triangles_native`` equals the JAX package's binding of
    the same native function."""
    rng = np.random.default_rng(5)
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    for host, dev in ((tt.build_mip_pair_atlas_host,
                       tt.build_mip_pair_atlas_device),
                      (tt.build_quad_packed_atlas_host,
                       tt.build_quad_packed_atlas_device),
                      (tt.build_quad_pair_atlas_host,
                       tt.build_quad_pair_atlas_device)):
        for bf16, dtype in ((True, torch.bfloat16), (False, torch.float32)):
            got = dev(torch.from_numpy(img), dtype)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.float().numpy(),
                                          host(img, bf16=bf16))
    sph = make_sphere(0.7, 12, 20)
    pos = sph.positions + rng.normal(0, 0.01, sph.positions.shape).astype(
        np.float32)
    got = native.morton_sort_triangles_native(pos, sph.indices)
    want = j_native.morton_sort_triangles_native(pos, sph.indices)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint32
    assert got.shape == (np.asarray(sph.indices).size // 3, 3)
    assert not np.array_equal(got.reshape(-1),
                              np.asarray(sph.indices, np.uint32).reshape(-1))
