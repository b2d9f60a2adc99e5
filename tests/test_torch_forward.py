"""The forward pass and the debug views of the port against the JAX
package's jitted frame: bench config 1's forward-only sphere (cut to
128x128 and a 24x48 sphere), and a forward sphere over a deferred floor
with shadows, culled point lights and a frame height that is not a whole
number of tiles (the forward raster's initial depth is padded)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.passes import (
    build_view_state as j_view, render_frame as j_render)
from zeldaengine_tpu.scene.mesh import (
    make_plane as j_plane, make_sphere as j_sphere)
from zeldaengine_tpu.scene.scenebuild import SceneBuilder as JBuilder
from zeldaengine_tpu.scene.world import CameraDesc, LightDesc, World
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.ops import lighting
from zeldaengine_tpu_torch.passes import render_frame
from zeldaengine_tpu_torch.scene import make_sphere
from zeldaengine_tpu_torch.scene.scenebuild import SceneBuilder, SceneMeta

from _torch_compare import assert_golden, to_numpy_leaves

torch.set_num_threads(1)

# bench.py:213-230 (config 1) at test size: forward only, no shadow map,
# no skydome.
FWD = dict(width=128, height=128, enable_shadow=False, enable_skydome=False,
           max_point_lights=8)


def _world(pos, lookat, points=()):
    w = World()
    w.main_camera = CameraDesc(position=np.asarray(pos, np.float32),
                               lookat=np.asarray(lookat, np.float32),
                               z_far=60.0)
    moon = np.array([20.0, 0.0, 20.0], np.float32)
    w.directional_lights = [
        LightDesc(position=moon, type=0,
                  color=np.array([1.0, 0.95, 0.85], np.float32),
                  intensity=3.0, direction=moon / np.linalg.norm(moon))]
    for p in points:
        w.point_lights.append(LightDesc(
            position=np.asarray(p, np.float32), type=1,
            color=np.array([0.9, 0.5, 0.2], np.float32), intensity=6.0,
            radius=3.0))
    return w


def _carry(jscene, jview, jmeta):
    return (scene_from_numpy(to_numpy_leaves(jscene), "cpu"),
            view_from_numpy(to_numpy_leaves(jview), "cpu"),
            SceneMeta(**dataclasses.asdict(jmeta)))


def _dv(view, dv, jax_side=False):
    return view._replace(debug_view=jnp.int32(dv) if jax_side
                         else torch.tensor(dv, dtype=torch.int32))


@pytest.fixture(scope="module")
def forward_only():
    """Bench config 1's scene (the reference OBJ is not in the repository:
    the procedural sphere stands in, as bench.py does without it)."""
    jcfg = JCFG.replace(**FWD)
    b = JBuilder(jcfg)
    b.enable_skydome = False
    b.add_object(j_sphere(1.0, rings=24, sectors=48), b.add_material({}),
                 deferred=False)
    jscene, jmeta = b.build()
    jview = j_view(_world((0.0, -3.0, 1.0), (0.0, 0.0, 0.0)), jcfg)
    return jcfg, jscene, jview, jmeta


def test_forward_only_frame_and_debug_views_match_the_jitted_frame(
        forward_only):
    """Views 0-9 (9 shows the lit forward pixel: the contact sheet is the
    deferred pass's), each by the golden criterion; no deferred triangle,
    the forward ids equal."""
    jcfg, jscene, jview, jmeta = forward_only
    scene, view, meta = _carry(jscene, jview, jmeta)
    assert meta.has_forward and not meta.has_deferred
    cfg = TEST_CONFIG.replace(**FWD)
    frames = []
    for dv in range(10):
        img, aux = render_frame(scene, _dv(view, dv), meta, cfg)
        jimg, jaux = j_render(jscene, _dv(jview, dv, True), jmeta, jcfg)
        assert_golden(img.numpy(), np.asarray(jimg), f"view {dv}")
        frames.append(img)
    np.testing.assert_array_equal(aux["forward_tri_id"].numpy(),
                                  np.asarray(jaux["forward_tri_id"]))
    assert (aux["tri_id"].numpy() == -1).all()
    assert 0.2 < (aux["forward_tri_id"].numpy() >= 0).mean() < 0.9
    assert torch.equal(frames[9], frames[0])
    assert not torch.equal(frames[1], frames[0])
    assert not torch.equal(frames[4], frames[7])


def test_port_builds_the_forward_scene(forward_only):
    """The port's own SceneBuilder gives the same pools and meta."""
    jcfg, jscene, _, jmeta = forward_only
    b = SceneBuilder(TEST_CONFIG.replace(**FWD))
    b.enable_skydome = False
    b.add_object(make_sphere(1.0, rings=24, sectors=48), b.add_material({}),
                 deferred=False)
    scene, meta = b.build("cpu")
    assert meta == SceneMeta(**dataclasses.asdict(jmeta))
    for k, v in to_numpy_leaves(jscene).items():
        if v is not None:
            np.testing.assert_array_equal(getattr(scene, k).float().numpy(),
                                          v, err_msg=k)


@pytest.fixture(scope="module")
def over_deferred():
    """A forward sphere standing on a deferred floor, shadows on, two
    point lights, 124 rows (8-row tiles: the forward raster's initial
    depth is padded by 4 rows)."""
    kw = dict(height=124, point_light_kernel="unroll")
    jcfg = JCFG.replace(**kw)
    b = JBuilder(jcfg)
    b.add_object(j_plane(4.0), b.add_material({}), deferred=True)
    sphere = j_sphere(0.5, rings=16, sectors=32)
    sphere.positions = sphere.positions + np.float32([0.3, 0.0, 0.6])
    b.add_object(sphere, b.add_material({}), deferred=False)
    jscene, jmeta = b.build()
    world = _world((2.5, -2.5, 1.8), (0.0, 0.0, 0.4),
                   points=[(-1.0, -1.0, 1.0), (1.0, 0.5, 0.8)])
    jview = j_view(world, jcfg, light_capacities=(2, 4, 2),
                   animate_point_lights=False)
    return kw, jcfg, jscene, jview, jmeta


@pytest.mark.parametrize("dv", [0, 8])
def test_forward_over_deferred_matches_the_jitted_frame(over_deferred, dv):
    """The lit frame and the raw shadow factor (view 8, recomputed ungated
    for the forward pixels too)."""
    kw, jcfg, jscene, jview, jmeta = over_deferred
    scene, view, meta = _carry(jscene, jview, jmeta)
    cfg = TEST_CONFIG.replace(**kw)
    img, aux = render_frame(scene, _dv(view, dv), meta, cfg)
    jimg, jaux = j_render(jscene, _dv(jview, dv, True), jmeta, jcfg)
    assert tuple(img.shape) == (124, 128, 3)
    assert_golden(img.numpy(), np.asarray(jimg))
    fwd = aux["forward_tri_id"].numpy() >= 0
    np.testing.assert_array_equal(fwd, np.asarray(jaux["forward_tri_id"])
                                  >= 0)
    assert 0.02 < fwd.mean() < 0.5
    # The sphere hides part of the floor: those pixels keep the GBuffer's
    # triangle but show the forward pixel.
    assert (aux["tri_id"].numpy()[fwd] >= 0).any()
    assert (aux["depth"] <= aux["gbuffer_depth"]).all()


def test_forward_pixels_cull_their_own_lights(over_deferred, monkeypatch):
    """Under "auto" the point-light kernel's path runs once per pass, each
    with lights culled against its own visible surface, and gives the
    frame of the plain loop."""
    kw, _, jscene, jview, jmeta = over_deferred
    scene, view, meta = _carry(jscene, jview, jmeta)
    cfg = TEST_CONFIG.replace(**kw)
    calls = []
    plain = lighting.point_lighting
    monkeypatch.setattr(lighting, "point_lighting",
                        lambda *a, **k: calls.append(a[0].shape) or
                        plain(*a, **k))
    img, aux = render_frame(scene, view, meta,
                            cfg.replace(point_light_kernel="auto"))
    assert len(calls) == 2 and int(aux["light_drops"]) == 0
    unrolled, _ = render_frame(scene, view, meta, cfg)
    np.testing.assert_allclose(img.numpy(), unrolled.numpy(), rtol=1e-5,
                               atol=1e-5)
