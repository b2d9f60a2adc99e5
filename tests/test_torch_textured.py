"""Textured materials and the variable-lod reflection (bench config 3t at
test size: TEST_CONFIG, grass 50, rocks 4) against the JAX package: the
material fetch (per-combo constants + one mip-pair row fetch of the
varying channels), both variable-lod reflection tiers, the whole frame
against the jitted JAX frame, and the port's own scene build. Both
packages read one generated Profab directory (``cache_dir``): the JAX
package seeds its textures per process."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.ops import lighting as jl
from zeldaengine_tpu.passes import (
    build_view_state as j_view, render_frame as j_render)
from zeldaengine_tpu.passes import gbuffer as jg
from zeldaengine_tpu.scene.demo import build_textured_demo_scene as j_build
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.ops import lighting as tl
from zeldaengine_tpu_torch.ops import texture as tt
from zeldaengine_tpu_torch.passes import gbuffer as tg
from zeldaengine_tpu_torch.passes import render_frame
from zeldaengine_tpu_torch.scene.demo import (
    build_textured_demo_scene, write_textured_profabs)
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta

from _torch_compare import assert_golden, to_numpy_leaves

torch.set_num_threads(1)

GRASS, ROCKS = 50, 4
KW = dict(point_light_kernel="unroll")


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("profabs3t"))
    jcfg = JCFG.replace(**KW)
    jscene, jmeta, jworld = j_build(jcfg, grass=GRASS, rocks=ROCKS,
                                    cache_dir=cache)
    jview = j_view(jworld, jcfg, time=0.1, roll_light=0.02)
    scene = scene_from_numpy(to_numpy_leaves(jscene), "cpu")
    view = view_from_numpy(to_numpy_leaves(jview), "cpu")
    meta = SceneMeta(**dataclasses.asdict(jmeta))
    return cache, jcfg, jscene, jview, jmeta, scene, view, meta


def _inputs(seed, n_combo, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    combo = rng.integers(0, n_combo, shape).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, shape + (2,)).astype(np.float32)
    lod = rng.uniform(-1.0, 8.0, shape).astype(np.float32)
    return combo, uv, lod


def test_material_texels_match_jax(textured):
    """The varying channels through the mip-pair atlas (one row fetch), the
    constant ones from the per-combo table, in canonical order: bit for
    bit."""
    _, jcfg, jscene, _, jmeta, scene, _, meta = textured
    assert meta.tex_channels == (0, 1, 2, 3, 4, 9, 10, 11)
    assert scene.combined_atlas.dtype == torch.bfloat16
    combo, uv, lod = _inputs(3, scene.mat_const.shape[0])
    want = jg._material_texels(jscene, jcfg, jnp.asarray(combo),
                               jnp.asarray(uv), jnp.asarray(lod),
                               jmeta.tex_channels)
    got = tg._material_texels(scene, TEST_CONFIG, torch.from_numpy(combo),
                              torch.from_numpy(uv), torch.from_numpy(lod),
                              meta.tex_channels)
    assert tuple(got.shape) == (64, 64, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tier", ["cube_pair1", "quad_atlas"])
def test_reflection_tiers_match_jax(textured, tier):
    """The variable-lod reflection: the half-resolution mip-pair cube at
    lod - 1 (the textured scene's tier: its roughness texture spans
    [0.25, 1]) and the quad-packed cube atlas at the lod, on a random cube
    (the demo's faces are flat) packed as the scene build packs it. Held
    at test_torch_shading.py's tolerance for reflection_color (2e-5
    absolute, 5e-5 relative: the BRDF fit and the mip formula are
    elementwise math whose last bits differ between XLA and PyTorch); the
    taps alone are bit for bit in test_torch_texture.py."""
    _, jcfg, _, _, _, scene, _, _ = textured
    assert scene.cube_const is None and scene.cube_pair1 is not None
    size = TEST_CONFIG.cubemap_size
    rng = np.random.default_rng(7)
    faces = rng.random((6, size, size, 4)).astype(np.float32)
    if tier == "cube_pair1":
        lvl1 = faces.reshape(6, size // 2, 2, size // 2, 2, 4).mean((2, 4))
        atlas = tt.round_bf16(tt.build_mip_pair_atlas(lvl1[..., :3]))
    else:
        atlas = tt.round_bf16(tt.build_quad_packed_atlas(faces))
    j_atlas = jnp.asarray(atlas, jnp.bfloat16)
    t_atlas = torch.from_numpy(atlas).to(torch.bfloat16)
    hw = (48, 48)
    n = rng.standard_normal(hw + (3,)).astype(np.float32)
    v = rng.standard_normal(hw + (3,)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    ins = dict(base_color=rng.random(hw + (3,)), metallic=rng.random(hw),
               roughness=rng.uniform(0.25, 1.0, hw), n=n, v=v,
               ndotv=np.clip((n * v).sum(-1), 0, 1), ao=rng.random(hw))
    ins = {k: np.asarray(a, np.float32) for k, a in ins.items()}
    pair1 = tier == "cube_pair1"
    want = jl.reflection_color(
        *(jnp.asarray(a) for a in ins.values()),
        j_atlas if not pair1 else None, jcfg.cubemap_size,
        jcfg.cubemap_mips, cube_pair1=j_atlas if pair1 else None)
    got = tl.reflection_color(
        *(torch.from_numpy(a) for a in ins.values()),
        t_atlas if not pair1 else None, TEST_CONFIG.cubemap_size,
        float(TEST_CONFIG.cubemap_mips),
        cube_pair1=t_atlas if pair1 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=5e-5)
    assert float(got.std()) > 1e-3


def test_textured_frame_meets_golden_criterion_against_the_jitted_frame(
        textured):
    """The whole frame (textured GBuffer, variable-lod reflection, shadows,
    skydome) against the JAX package's jitted frame of the same carried
    scene and view."""
    _, jcfg, jscene, jview, jmeta, scene, view, meta = textured
    jimg, jaux = j_render(jscene, jview, jmeta, jcfg)
    img, aux = render_frame(scene, view, meta, TEST_CONFIG.replace(**KW))
    assert bool(torch.isfinite(img).all())
    assert_golden(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(aux["tri_id"].numpy(),
                                  np.asarray(jaux["tri_id"]))
    covered = aux["tri_id"].numpy() >= 0
    assert 0.3 < covered.mean() < 0.99
    # Textured: the covered pixels' colours vary within a triangle.
    assert float(img.numpy()[covered].std()) > 0.05


def test_port_builds_the_same_textured_scene(textured):
    """On the same Profab directory the port's builder gives the JAX
    package's pools bit for bit, so its frame is the carried scene's."""
    cache, _, jscene, _, jmeta, scene, view, meta = textured
    own, own_meta, world = build_textured_demo_scene(
        TEST_CONFIG.replace(**KW), grass=GRASS, rocks=ROCKS,
        cache_dir=cache, device="cpu")
    assert own_meta == meta
    for k, v in to_numpy_leaves(jscene).items():
        got = getattr(own, k)
        assert (v is None) == (got is None), k
        if v is not None:
            np.testing.assert_array_equal(got.float().numpy(), v, err_msg=k)
    cfg = TEST_CONFIG.replace(**KW)
    a, _ = render_frame(own, view, own_meta, cfg)
    b, _ = render_frame(scene, view, meta, cfg)
    assert torch.equal(a, b)


def test_profab_textures_are_seeded_stably(tmp_path):
    """The port seeds each Profab's texture noise from zlib.crc32 of its
    name (the JAX package's ``hash(name)`` changes per process): two
    writes give the same bytes, and the directory is written once."""
    a, b = tmp_path / "a", tmp_path / "b"
    write_textured_profabs(str(a), 16)
    write_textured_profabs(str(b), 16)
    files = sorted(p.relative_to(a) for p in a.rglob("*.png"))
    assert len(files) == 35
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    stamp = a / "COMPLETE"
    before = os.path.getmtime(stamp)
    write_textured_profabs(str(a), 16)
    assert os.path.getmtime(stamp) == before
