"""The merged environment tap of the port (``ops/envtap.py`` and the
row-context samplers of ``ops/texture.py``) against the JAX package's on
the same seeded inputs, at tests/test_envtap.py's tolerance (atol 1e-5),
and the merged table of the port's scene build against the JAX package's
(equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.ops import envtap as jenv
from zeldaengine_tpu.ops import texture as jtex
from zeldaengine_tpu.scene import make_cube as j_cube, make_plane as j_plane
from zeldaengine_tpu.scene.scenebuild import SceneBuilder as JBuilder
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.ops import envtap as tenv
from zeldaengine_tpu_torch.ops import texture as ttex
from zeldaengine_tpu_torch.scene import make_cube, make_plane
from zeldaengine_tpu_torch.scene.scenebuild import SceneBuilder

torch.set_num_threads(1)

CS, SS = 32, 64  # cube face, sky / background size
ATOL = 1e-5


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tables(seed):
    """(faces, sky, bg, JAX table, port table, shapes) on seeded images."""
    rng = np.random.default_rng(seed)
    faces = rng.random((6, CS, CS, 4)).astype(np.float32)
    sky = rng.random((1, SS, SS, 4)).astype(np.float32)
    bg = rng.random((1, SS, SS, 4)).astype(np.float32)
    jparts = (jtex.build_quad_pair_atlas_host(faces),
              jtex.build_quad_packed_atlas_host(sky),
              jtex.build_quad_packed_atlas_host(bg))
    jtable, _ = jenv.flatten_env_tables(*(jnp.asarray(p) for p in jparts))
    tparts = (ttex.build_quad_pair_atlas_host(faces),
              ttex.build_quad_packed_atlas_host(sky),
              ttex.build_quad_packed_atlas_host(bg))
    ttable, rows = tenv.flatten_env_tables(
        *(torch.from_numpy(p).to(torch.bfloat16) for p in tparts))
    shapes = tuple(tuple(p.shape[:3]) for p in jparts)
    assert rows[0] == 6 * CS * CS // 2 and ttable.shape == (
        sum(rows), tenv.ENV_CH)
    return faces, jtable, ttable, shapes


def _pixels(seed, h=16, w=24):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((h, w, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(
        d=d, lod=(rng.random((h, w)) * 6.0 - 0.5).astype(np.float32),
        uv=rng.uniform(-1.5, 2.5, (h, w, 2)).astype(np.float32),
        uv2=rng.uniform(-1.5, 2.5, (h, w, 2)).astype(np.float32),
        covered=rng.random((h, w)) > 0.5, use_sky=rng.random((h, w)) > 0.3,
        layer=rng.integers(0, 6, (h, w)).astype(np.int32))


def test_quad_pair_atlas_builders_match_jax():
    """Host builders equal (the bf16 table bit for bit); the device builder
    within one float32 rounding of the host one (its box means may sum in
    another order)."""
    faces = np.random.default_rng(1).random((6, CS, CS, 4)).astype(
        np.float32)
    want = jtex.build_quad_pair_atlas_np(faces)
    got = ttex.build_quad_pair_atlas_np(faces)
    assert got.shape == (6, CS, CS // 2, 208)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttex.build_quad_pair_atlas_host(faces),
                                  _np(jtex.build_quad_pair_atlas_host(faces)))
    dev = ttex.build_quad_pair_atlas_device(torch.from_numpy(faces),
                                            out_dtype=torch.float32)
    np.testing.assert_allclose(dev.numpy(), want, atol=1e-6, rtol=0)


def test_pair_row_context_and_filter_match_jax():
    """The index half (layer, x, y and every context value) equal; the
    filter of a fetched pair row within atol."""
    p = _pixels(2)
    faces = np.random.default_rng(3).random((6, CS, CS, 4)).astype(
        np.float32)
    atlas = ttex.build_quad_pair_atlas_np(faces).reshape(6, CS, CS * 2, 52)
    want = jtex.pair_row_context(jnp.asarray(p["layer"]),
                                 jnp.asarray(p["uv"]), jnp.asarray(p["lod"]),
                                 CS)
    got = ttex.pair_row_context(torch.from_numpy(p["layer"]),
                                torch.from_numpy(p["uv"]),
                                torch.from_numpy(p["lod"]), CS)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k].numpy(),
                                      np.asarray(want[3][k]), err_msg=k)
    layer, xg, y = (np.asarray(w) for w in want[:3])
    row = atlas[layer, y, xg]  # (H, W, 52)
    jout = jtex.pair_filter_row(jnp.asarray(row), want[3], 4)
    tout = ttex.pair_filter_row(torch.from_numpy(row), got[3], 4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)


def test_quad_row_context_select_and_filter_match_jax():
    p = _pixels(4)
    sky = np.random.default_rng(5).random((1, SS, SS, 4)).astype(np.float32)
    atlas = ttex.build_quad_packed_atlas(sky)  # (1, SS, SS/2, 64)
    zeros = np.zeros(p["layer"].shape, np.int32)
    want = jtex.quad_row_context(jnp.asarray(zeros), jnp.asarray(p["uv"]),
                                 SS)
    got = ttex.quad_row_context(torch.from_numpy(zeros),
                                torch.from_numpy(p["uv"]), SS)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k].numpy(),
                                      np.asarray(want[3][k]), err_msg=k)
    x = np.asarray(want[1])
    row = atlas[0, np.asarray(want[2]), x // 4]  # (H, W, 64)
    jsel = jtex.quad_select(jnp.asarray(row), want[3]["qj"], 16)
    tsel = ttex.quad_select(torch.from_numpy(row), got[3]["qj"], 16)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    jout = jtex.quad_filter_row(jsel, want[3], 4)
    tout = ttex.quad_filter_row(tsel, got[3], 4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    # The same value the plain quad tap gives.
    base = ttex.sample_base(torch.from_numpy(atlas).to(torch.bfloat16),
                            torch.from_numpy(zeros),
                            torch.from_numpy(p["uv"]), SS, quad=True)
    assert float(base.abs().max()) > 0.0


@pytest.mark.parametrize("with_bg", [True, False])
def test_sample_env_merged_matches_jax(with_bg):
    """The one row fetch of reflection, sky and background: the tables
    equal, each slot within atol where its selector chose it."""
    _, jtable, ttable, shapes = _tables(6)
    np.testing.assert_array_equal(ttable.to(torch.float32).numpy(),
                                  _np(jtable))
    p = _pixels(7)
    bg = p["uv2"] if with_bg else None
    want = jenv.sample_env_merged(
        jtable, shapes, jnp.asarray(p["covered"]), jnp.asarray(p["d"]),
        jnp.asarray(p["lod"]), CS, jnp.asarray(p["uv"]),
        jnp.asarray(p["use_sky"]),
        None if bg is None else jnp.asarray(bg), SS, SS)
    got = tenv.sample_env_merged(
        ttable, shapes, torch.from_numpy(p["covered"]),
        torch.from_numpy(p["d"]), torch.from_numpy(p["lod"]), CS,
        torch.from_numpy(p["uv"]), torch.from_numpy(p["use_sky"]),
        None if bg is None else torch.from_numpy(bg), SS, SS)
    cov, sky = p["covered"], p["use_sky"]
    masks = (cov, ~cov & sky, ~cov & ~sky if with_bg else ~cov & sky)
    for g, w, m in zip(got, want, masks):
        assert tuple(g.shape) == cov.shape + (4,)
        assert m.any()
        np.testing.assert_allclose(g.numpy()[m], np.asarray(w)[m],
                                   atol=ATOL)


def test_scene_build_env_table_matches_jax():
    """``SceneBuilder.build`` with ``env_merge``: the merged table (bf16)
    and its shapes equal the JAX package's on the same images."""
    rng = np.random.default_rng(8)
    faces = rng.random((6, 32, 32, 4)).astype(np.float32)
    sky = rng.random((64, 64, 4)).astype(np.float32)
    bg = rng.random((64, 64, 4)).astype(np.float32)
    out = []
    for builder, cfg, cube, plane in (
            (JBuilder, JCFG, j_cube, j_plane),
            (SceneBuilder, TEST_CONFIG, make_cube, make_plane)):
        b = builder(cfg.replace(env_merge=True))
        b.enable_background = True
        b.add_object(plane(4.0), b.add_material({}), deferred=True)
        b.add_object(cube(1.0, center=(0, 0, 0.5)), b.add_material({}),
                     deferred=True)
        b.set_cubemap(faces)
        b.set_skydome_texture(sky)
        b.set_background_texture(bg)
        out.append(b.build() if builder is JBuilder else b.build("cpu"))
    (jscene, jmeta), (scene, meta) = out
    assert meta.env_shapes == tuple(tuple(s) for s in jmeta.env_shapes)
    assert scene.env_table.dtype == torch.bfloat16
    np.testing.assert_array_equal(scene.env_table.to(torch.float32).numpy(),
                                  _np(jscene.env_table))
