"""The frame options of the port against the JAX package's jitted frame on
the same carried-across scene and view: the rasterized dome mesh with the
background pass, the merged environment tap with the background pass, and
the half-resolution reflection on the textured demo. Each is held to the
golden criterion (tests/test_golden.py) and must be no further from the
reference than the same scene without the option."""

import dataclasses

import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.passes import (
    build_view_state as j_view, render_frame as j_render)
from zeldaengine_tpu.scene import scenebuild as j_scenebuild
from zeldaengine_tpu.scene.demo import (
    build_demo_scene as j_build, build_textured_demo_scene as j_build3t)
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.ops import rasterize_cuda
from zeldaengine_tpu_torch.passes import render_frame
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta

from _torch_compare import assert_golden, to_numpy_leaves

torch.set_num_threads(1)

GRASS, ROCKS = 50, 4
VIEW = dict(time=0.1, roll_light=0.02)
KW = dict(point_light_kernel="unroll")


def _background_image(size):
    """The background texture the scenes of this file get (seeded)."""
    return np.random.default_rng(21).random((size, size, 4)).astype(
        np.float32)


def _sky_image(size):
    """A smooth seeded equirect (the demo's own sky is uniform: the dome's
    uv would not show)."""
    phase = np.random.default_rng(24).uniform(0.0, 2.0 * np.pi, (2, 4))
    t = np.arange(size, dtype=np.float64) / size * 2.0 * np.pi
    img = 0.5 + 0.25 * np.sin(t[None, :, None] + phase[0]) * np.cos(
        t[:, None, None] + phase[1])
    return img.astype(np.float32)


def _textured_builds(jcfg):
    """The JAX package's builder with the seeded background image, a
    smooth seeded sky and a seeded cubemap (the demo's own cube is
    uniform: every reflection tap would read one value)."""
    build = j_scenebuild.SceneBuilder.build
    rng = np.random.default_rng(22)
    faces = rng.random((6, jcfg.cubemap_size, jcfg.cubemap_size, 4)).astype(
        np.float32)

    def patched(self, *a, **k):
        self.set_background_texture(_background_image(jcfg.background_size))
        self.set_skydome_texture(_sky_image(jcfg.background_size))
        self.set_cubemap(faces)
        return build(self, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(j_scenebuild.SceneBuilder, "build", patched)
    return mp


def _carry(jscene, jview, jmeta):
    return (scene_from_numpy(to_numpy_leaves(jscene), "cpu"),
            view_from_numpy(to_numpy_leaves(jview), "cpu"),
            SceneMeta(**dataclasses.asdict(jmeta)))


def _off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > 4 / 255).mean())


def _held(jcfg, cfg, jscene, jview, jmeta, what):
    """The port's frame of the carried-across scene against the JAX
    frame: (fraction of values off by > 4/255, port image, aux)."""
    jimg = np.asarray(j_render(jscene, jview, jmeta, jcfg)[0])
    scene, view, meta = _carry(jscene, jview, jmeta)
    img, aux = render_frame(scene, view, meta, cfg)
    assert bool(torch.isfinite(img).all())
    assert_golden(img.numpy(), jimg, what)
    return _off(img.numpy(), jimg), img, aux


@pytest.fixture(scope="module")
def demo_with_background():
    """The small demo scene (TEST_CONFIG, grass 50, rocks 4) with the
    seeded background image, built by the JAX package, and its
    separate-tap analytic frame's distance from the reference."""
    jcfg = JCFG.replace(enable_background=True, **KW)
    mp = _textured_builds(jcfg)
    try:
        jscene, jmeta, jworld = j_build(jcfg, grass=GRASS, rocks=ROCKS)
        jcfg_env = jcfg.replace(env_merge=True)
        jscene_env, jmeta_env, _ = j_build(jcfg_env, grass=GRASS,
                                           rocks=ROCKS)
    finally:
        mp.undo()
    assert jmeta.enable_background and jscene_env.env_table is not None
    jview = j_view(jworld, jcfg, **VIEW)
    return dict(jcfg=jcfg, cfg=TEST_CONFIG.replace(enable_background=True,
                                                   **KW),
                jscene=jscene, jmeta=jmeta, jworld=jworld, jview=jview,
                jscene_env=jscene_env, jmeta_env=jmeta_env)


def test_mesh_skydome_and_background_match_jax(demo_with_background,
                                               monkeypatch):
    """The dome mesh through the pair rasterizer with ids and the frame's
    depth as initial depth, and the background rect where the frame is
    left at the far plane, against the JAX package's mesh frame."""
    d = demo_with_background
    # The far plane inside the dome (radius 30, the camera 8.7 from its
    # centre): the far side of the dome is clipped, so the background
    # shows there.
    d["jworld"].main_camera.z_far = 33.0
    jview = j_view(d["jworld"], d["jcfg"], **VIEW)
    base_off, base_img, _ = _held(d["jcfg"], d["cfg"], d["jscene"], jview,
                                  d["jmeta"], "analytic sky + background")
    jcfg = d["jcfg"].replace(skydome_mode="mesh")
    cfg = d["cfg"].replace(skydome_mode="mesh")
    calls = []
    ras = rasterize_cuda.rasterize_pairs

    def noted(*a, **k):
        calls.append(k)
        return ras(*a, **k)

    from zeldaengine_tpu_torch.passes import frame as frame_graph
    monkeypatch.setattr(frame_graph, "rasterize_pairs", noted)
    off, img, aux = _held(jcfg, cfg, d["jscene"], jview, d["jmeta"],
                          "mesh dome + background")
    assert off <= base_off
    # The shadow map, then the dome with ids on the frame's depth.
    assert [k.get("depth_only", False) for k in calls] == [True, False]
    assert calls[1]["init_depth"] is not None
    # The dome covers part of the frame; the background shows where the
    # frame stays at the far plane.
    far = (aux["depth"] >= 1.0).numpy()
    assert 0.05 < far.mean() < 0.95 and int(aux["live_pairs"]["skydome"]) > 0
    want = np.asarray(_background_image(cfg.background_size))
    assert float(np.abs(img.numpy()[far]).std()) > 0.01
    assert want.std() > 0.1
    # The dome mesh approximates the analytic dome (its infinite
    # tessellation limit; tests/test_skydome.py's bound).
    diff = (img - base_img).abs()
    assert float(diff.mean()) < 5e-3


def test_env_merge_and_background_match_jax(demo_with_background):
    """Reflection and background through one row fetch of the merged
    table: against the JAX package's env-merge frame by the golden
    criterion, and within 2e-3 of the port's separate-tap frame (the
    JAX package's own bound, tests/test_envtap.py). The skydome is off, so
    every uncovered pixel takes the background's row (the sky's rows are
    held in tests/test_torch_envtap.py)."""
    d = demo_with_background
    jcfg, cfg = (c.replace(enable_skydome=False) for c in (d["jcfg"],
                                                           d["cfg"]))
    base_off, base_img, _ = _held(jcfg, cfg, d["jscene"], d["jview"],
                                  d["jmeta"], "separate taps")
    off, img, aux = _held(jcfg.replace(env_merge=True),
                          cfg.replace(env_merge=True), d["jscene_env"],
                          d["jview"], d["jmeta_env"], "env merge")
    assert off <= base_off
    np.testing.assert_allclose(img.numpy(), base_img.numpy(), atol=2e-3)
    far = (aux["depth"] >= 1.0).numpy()
    assert 0.05 < far.mean() < 0.95


def test_reflection_half_on_the_textured_demo(tmp_path):
    """The half-resolution reflection tap (the variable-lod tier of the
    textured demo; the untextured demo's constant-lod table ignores the
    lod) against the JAX frame, and against the full-resolution tap."""
    cache = str(tmp_path / "profabs3t")
    jcfg = JCFG.replace(**KW)
    mp = _textured_builds(jcfg)
    try:
        jscene, jmeta, jworld = j_build3t(jcfg, grass=GRASS, rocks=ROCKS,
                                          cache_dir=cache)
    finally:
        mp.undo()
    assert jscene.cube_const is None
    jview = j_view(jworld, jcfg, **VIEW)
    cfg = TEST_CONFIG.replace(**KW)
    base_off, base_img, _ = _held(jcfg, cfg, jscene, jview, jmeta,
                                  "textured, full-resolution reflection")
    off, img, _ = _held(jcfg.replace(reflection_half=True),
                        cfg.replace(reflection_half=True), jscene, jview,
                        jmeta, "textured, half-resolution reflection")
    assert off <= base_off
    # The option changes the frame (not bit-exact to the full tap).
    assert not torch.equal(img, base_img)
