"""The frame with culled point lights: the port's default
(``point_light_kernel="auto"``: cull + the point-light kernel's plain
version on the CPU) against the JAX package's frame through its
point-light Pallas kernel (interpret mode), and the engine shell's
default path."""

import dataclasses

import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.passes import (
    build_view_state as j_view, render_frame as j_render)
from zeldaengine_tpu.scene.demo import build_demo_scene as j_build
from zeldaengine_tpu.scene.world import LightDesc
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.ops import lighting
from zeldaengine_tpu_torch.passes import render_frame
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta

from _torch_compare import to_numpy_leaves

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def carried():
    """tests/test_lighting_pallas.py's frame: the demo scene plus six warm
    point lights, shadows off (the shadow map is held elsewhere), the JAX
    scene and view carried across as NumPy."""
    jcfg = JCFG.replace(enable_shadow=False)
    jscene, jmeta, world = j_build(jcfg, grass=40, rocks=4)
    rng = np.random.RandomState(7)
    for _ in range(6):
        a = rng.uniform(0, 2 * np.pi)
        d = rng.uniform(0.5, 6.0)
        world.point_lights.append(LightDesc(
            position=np.array([np.sin(a) * d, np.cos(a) * d, 1.0],
                              np.float32),
            type=1, color=np.array([0.9, 0.5, 0.2], np.float32),
            intensity=6.0, radius=2.5))
    jview = j_view(world, jcfg, time=0.0)
    scene = scene_from_numpy(to_numpy_leaves(jscene), "cpu")
    view = view_from_numpy(to_numpy_leaves(jview), "cpu")
    meta = SceneMeta(**dataclasses.asdict(jmeta))
    return jcfg, jscene, jview, jmeta, scene, view, meta


def test_default_frame_matches_the_jax_kernel_frame(carried, monkeypatch):
    jcfg, jscene, jview, jmeta, scene, view, meta = carried
    assert int(jview.lights_count[1]) == 22
    cfg = TEST_CONFIG.replace(enable_shadow=False)
    assert cfg.point_light_kernel == "auto"
    calls = []
    plain = lighting.point_lighting
    monkeypatch.setattr(lighting, "point_lighting",
                        lambda *a, **k: calls.append(k) or plain(*a, **k))
    img, aux = render_frame(scene, view, meta, cfg)
    assert [c["block_h"] for c in calls] == [cfg.point_block_h]
    assert int(aux["light_drops"]) == 0
    # The JAX frame as it runs by default, jitted: the port fuses the
    # multiply-adds XLA fuses in the setup, the transforms and the raster
    # depth (test_torch_rasterize.py), so every pixel sees the same
    # triangle but at exact depth ties, which the port resolves by pair
    # order and the reference's CPU raster by triangle order (PARITY.md,
    # "Depth-tie winner deviation"): one pixel here.
    jimg, jaux = j_render(jscene, jview, jmeta,
                          jcfg.replace(point_light_kernel="pallas"))
    same = aux["tri_id"].numpy() == np.asarray(jaux["tri_id"])
    assert (~same).sum() <= 1
    np.testing.assert_array_equal(aux["depth"].numpy()[~same],
                                  np.asarray(jaux["depth"])[~same])
    # tests/test_lighting_pallas.py:117's tolerance.
    np.testing.assert_allclose(img.numpy()[same], np.asarray(jimg)[same],
                               rtol=1e-5, atol=1e-5)
    # ... and the unrolled loop of the port gives the same frame.
    unrolled, _ = render_frame(scene, view, meta,
                               cfg.replace(point_light_kernel="unroll"))
    np.testing.assert_allclose(img.numpy(), unrolled.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_tiled_loop_frame_at_a_large_light_table(carried):
    """A table of >= tiled_lights_min slots under "unroll" takes the tiled
    loop; its frame equals the kernel path's."""
    _, _, _, _, scene, view, meta = carried
    table = torch.zeros((128, 4, 4))
    table[:view.point_lights.shape[0]] = view.point_lights
    big = view._replace(point_lights=table)
    cfg = TEST_CONFIG.replace(enable_shadow=False)
    tiled, aux_t = render_frame(scene, big, meta,
                                cfg.replace(point_light_kernel="unroll"))
    kern, aux_k = render_frame(scene, big, meta, cfg)
    np.testing.assert_allclose(tiled.numpy(), kern.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(aux_t["light_drops"]) == int(aux_k["light_drops"]) == 0


def test_engine_on_the_cpu_renders_through_the_culled_path(monkeypatch):
    from zeldaengine_tpu_torch.engine import Engine
    from zeldaengine_tpu_torch.scene import demo_world

    calls = []
    plain = lighting.point_lighting
    monkeypatch.setattr(lighting, "point_lighting",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    eng = Engine(TEST_CONFIG.replace(frames_in_flight=1,
                                     present_mode="fifo"),
                 world=demo_world(grass=20, rocks=2), device="cpu")
    assert eng.config.point_light_kernel == "auto"
    img = eng.tick()
    assert calls == [1]
    assert img.shape == (128, 128, 3) and img.std() > 1
    assert Engine(device="cpu", world=demo_world(grass=2, rocks=1)) \
        .config.point_light_kernel == "auto"
