"""Plain version of kernel bilinear_tap against the JAX package's Pallas
tap kernel in interpret mode and against sample_base on the quad atlas.
The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.ops import texture as jtex
from zeldaengine_tpu.ops import window_tap as jwt
from zeldaengine_tpu_torch.ops import texture as ttex
from zeldaengine_tpu_torch.ops import window_tap as twt

torch.set_num_threads(1)

S = 256


def _images(seed=42):
    img = np.random.default_rng(seed).random((S, S, 4)).astype(np.float32)
    jquad = jnp.asarray(jtex.build_quad_packed_atlas(img[None])) \
        .astype(jnp.bfloat16)
    jplanes = jwt.planes_from_image_bf16(img)
    tquad = torch.from_numpy(
        ttex.build_quad_packed_atlas_host(img[None])).to(torch.bfloat16)
    tplanes = twt.planes_from_image_bf16(img)
    return img, jquad, jplanes, tquad, tplanes


def _uv(kind, h, w):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if kind == "smooth":
        u, v = xx / w * 0.4 + 0.1, yy / h * 0.1 + 0.3
    elif kind == "seam":  # crosses the repeat seam, and uv outside [0, 1]
        u = np.linspace(0.9, 1.1, w)[None, :].repeat(h, 0)
        v = np.linspace(-0.05, 0.05, h)[:, None].repeat(w, 1)
    else:  # random, incl. negative
        rng = np.random.default_rng(1)
        u, v = rng.random((h, w)) * 3 - 1, rng.random((h, w)) * 3 - 1
    return np.stack([u, v], -1).astype(np.float32)


def test_host_atlases_and_planes_equal_jax():
    img, jquad, jplanes, tquad, tplanes = _images()
    np.testing.assert_array_equal(
        np.asarray(jquad.astype(jnp.float32)), tquad.float().numpy())
    np.testing.assert_array_equal(np.asarray(jplanes), tplanes.numpy())
    np.testing.assert_array_equal(
        jtex.build_mip_pair_atlas(img[None, :64, :64]),
        ttex.build_mip_pair_atlas(img[None, :64, :64]))


@pytest.mark.parametrize("kind,h,w", [("smooth", 32, 256), ("seam", 8, 128),
                                      ("random", 8, 128)])
def test_plain_tap_matches_pallas_interpret_and_sample_base(kind, h, w):
    _, jquad, jplanes, tquad, tplanes = _images()
    uv = _uv(kind, h, w)
    jref = jtex.sample_base(jquad, jnp.zeros((h, w), jnp.int32),
                            jnp.asarray(uv), S, quad=True)
    jout, ovf = jwt.sample_base_window(jplanes, jnp.asarray(uv), None, S,
                                       interpret=True)
    assert int(ovf) == 0
    out, overflow = twt.sample_base_window(tplanes, torch.from_numpy(uv),
                                           None, S)
    assert overflow == 0
    # 2e-7: same lerp order on the same bf16-rounded texels
    # (tests/test_window_tap.py's figure).
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-7,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), atol=2e-7,
                               rtol=0)
    # ... and the port's own quad-atlas sampler agrees with both.
    tref = ttex.sample_base(tquad, torch.zeros((h, w), dtype=torch.int32),
                            torch.from_numpy(uv), S, quad=True)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), atol=2e-7,
                               rtol=0)


def test_inactive_pixels_are_zero_and_active_ones_unchanged():
    _, _, jplanes, _, tplanes = _images()
    uv = _uv("smooth", 16, 256)
    active = np.zeros((16, 256), bool)
    active[:8, :128] = True
    active[12, 200] = True
    out, _ = twt.sample_base_window(tplanes, torch.from_numpy(uv),
                                    torch.from_numpy(active), S)
    full, _ = twt.sample_base_window(tplanes, torch.from_numpy(uv), None, S)
    jout, _ = jwt.sample_base_window(jplanes, jnp.asarray(uv),
                                     jnp.asarray(active), S, interpret=True)
    assert not out.numpy()[~active].any()
    np.testing.assert_array_equal(out.numpy()[active], full.numpy()[active])
    np.testing.assert_allclose(out.numpy()[active],
                               np.asarray(jout)[active], atol=2e-7, rtol=0)


def test_cube_face_selection_matches_jax():
    d = np.random.default_rng(3).normal(size=(40, 50, 3)).astype(np.float32)
    jf, juv = jtex.cube_direction_to_face_uv(jnp.asarray(d))
    tf, tuv = ttex.cube_direction_to_face_uv(torch.from_numpy(d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-6)


def test_wrapper_refuses_cpu_tensors_for_the_cuda_backend():
    _, _, _, _, tplanes = _images()
    with pytest.raises(RuntimeError, match="card"):
        twt.sample_base_window(tplanes, torch.zeros((4, 4, 2)), None, S,
                               backend="cuda")
    assert twt.sample_base_window.launches == 0
