"""Row bands of the frame: the port's ``render_rows`` band and
``parallel/tiles.py``'s ``render_frame_sharded`` over eight CPU devices
(``make_tile_mesh([cpu] * 8)``, the analogue of the eight virtual CPU
devices tests/conftest.py gives JAX) against the JAX package on the scenes
of tests/test_frame.py, carried across as NumPy: one interior band against
the JAX ``render_rows`` (jitted) with the same arguments, the sharded frame,
striped and contiguous, against the JAX package's jitted single-device
``render_frame`` at tests/test_frame.py's own bounds and against the port's
own full frame, ``band_pair_stats`` against the JAX package's over its
eight-device mesh, and the PCF backends without a kernel routed through
the frame."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.meshlet import build_meshlets as j_build_meshlets
from zeldaengine_tpu.parallel import tiles as jtiles
from zeldaengine_tpu.passes import build_view_state, render_frame as j_render
from zeldaengine_tpu.passes.frame import render_rows as j_rows
from zeldaengine_tpu.scene import make_cube, make_plane, make_sphere
from zeldaengine_tpu.scene.scenebuild import SceneBuilder
from zeldaengine_tpu.scene.world import CameraDesc, LightDesc, World
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.parallel import (
    band_pair_stats, jit_sharded_renderer, make_tile_mesh,
    render_frame_sharded)
from zeldaengine_tpu_torch.passes.frame import render_frame, render_rows
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta

from _torch_compare import assert_golden, to_numpy_leaves

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _world(camera, lookat, sun):
    w = World()
    w.main_camera = CameraDesc(position=np.array(camera, np.float32),
                               lookat=np.array(lookat, np.float32))
    sun = np.array(sun, np.float32)
    w.directional_lights = [
        LightDesc(position=sun, type=0,
                  color=np.array([1.0, 0.95, 0.8], np.float32),
                  intensity=4.0, direction=sun / np.linalg.norm(sun))]
    return w


def _carry(jscene, jmeta, jview):
    return (scene_from_numpy(to_numpy_leaves(jscene), "cpu"),
            view_from_numpy(to_numpy_leaves(jview), "cpu"),
            SceneMeta(**dataclasses.asdict(jmeta)))


@pytest.fixture(scope="module")
def small():
    """tests/test_frame.py::small_scene in both packages: (JAX scene, view,
    meta, config, the port's scene, view, meta, config)."""
    cfg = JCFG
    b = SceneBuilder(cfg)
    c = (np.indices((cfg.texture_size,) * 2).sum(0) // 8 % 2).astype(
        np.float32)
    img = np.stack([0.1 + 0.6 * c, 0.2 + 0.2 * c, 0.7 - 0.5 * c,
                    np.ones_like(c)], -1)
    mat_checker = b.add_material({0: img})
    b.add_object(make_plane(4.0), b.add_material({}), deferred=True)
    b.add_object(make_cube(1.0, center=(0, 0, 0.5)), mat_checker,
                 deferred=True)
    b.add_object(make_cube(0.4, center=(1.2, 0, 0.2)), mat_checker,
                 deferred=False)
    faces = np.zeros((6, cfg.cubemap_size, cfg.cubemap_size, 4), np.float32)
    faces[..., 2] = 0.25
    faces[..., 3] = 1
    b.set_cubemap(faces)
    scene, meta = b.build()
    w = _world([3.0, -3.0, 2.5], [0.0, 0.0, 0.5], [20.0, 0.0, 20.0])
    w.point_lights = [
        LightDesc(position=np.array([1.5, -1.0, 1.0], np.float32), type=1,
                  color=np.array([1.0, 0.2, 0.1], np.float32), intensity=5.0,
                  radius=3.0)]
    view = build_view_state(w, cfg, light_capacities=(2, 2, 2),
                            animate_point_lights=False)
    return (scene, view, meta, cfg, *_carry(scene, meta, view), TEST_CONFIG)


@pytest.fixture(scope="module")
def featured():
    """tests/test_frame.py::featured_scene (a meshlet sphere on a plane, 68
    point lights through the tiled cull) in both packages."""
    cfg = JCFG.replace(max_point_lights=96, adaptive_light_capacity=False)
    b = SceneBuilder(cfg)
    b.add_object(make_plane(6.0), b.add_material({}), deferred=True)
    sph = make_sphere(0.6, rings=16, sectors=24)
    ms = j_build_meshlets(sph.positions + np.array([0, 0, 0.8], np.float32),
                          sph.indices, normals=sph.normals, uvs=sph.uvs)
    b.add_meshlet_object(ms, b.add_material({}))
    scene, meta = b.build()
    assert meta.has_meshlets
    w = _world([3.5, -3.5, 2.5], [0.0, 0.0, 0.5], [20.0, 0.0, 20.0])
    rng = np.random.RandomState(7)
    for _ in range(68):
        a = rng.uniform(0, 2 * np.pi)
        d = rng.uniform(0.5, 2.5)
        w.point_lights.append(LightDesc(
            position=np.array([np.sin(a) * d, np.cos(a) * d, 1.0],
                              np.float32),
            type=1, intensity=3.0, radius=1.2,
            color=np.array([rng.uniform(0.3, 1.0), rng.uniform(0.2, 0.6),
                            0.2], np.float32)))
    view = build_view_state(w, cfg, light_capacities=(2, 96, 2),
                            animate_point_lights=False)
    assert view.point_lights.shape[0] > 64
    pcfg = TEST_CONFIG.replace(max_point_lights=96,
                               adaptive_light_capacity=False)
    return (scene, view, meta, cfg, *_carry(scene, meta, view), pcfg)


def test_interior_band_matches_the_jax_render_rows(small):
    """Rows [72, 96) (tile rows 9-11 of 8-row tiles, the forward cube's
    upper half among them) as a band on the full
    frame's shadow map, against the JAX package's jitted ``render_rows``
    with the same arguments: the image at the golden criterion of the
    port's frame tests, GBuffer depth and ids bit for bit (the final depth
    holds the sky's, 1e-4, as tests/test_torch_frame.py allows). The band
    is the same rows of the port's own full frame, bit for bit; a band
    that is not tile-aligned (rows [37, 58)) goes through the pair
    rasterizers too (tile rows 4-7, cropped) and gives the same rows."""
    jscene, jview, jmeta, jcfg, scene, view, meta, cfg = small
    jimg, jaux = j_render(jscene, jview, jmeta, jcfg)
    jsm = np.asarray(jaux["shadowmap"])
    y0, rows = 72, 24
    jb, jbaux = jax.jit(functools.partial(
        j_rows, meta=jmeta, config=jcfg, y0=y0, rows=rows,
        full_frame=False))(jscene, jview, shadowmap_override=jnp.asarray(jsm))
    img, aux = render_rows(scene, view, meta, cfg, y0=y0, rows=rows,
                           full_frame=False,
                           shadowmap_override=torch.from_numpy(jsm.copy()))
    assert tuple(img.shape) == (rows, cfg.width, 3)
    assert_golden(img.numpy(), np.asarray(jb), "band")
    for key in ("gbuffer_depth", "tri_id", "forward_tri_id"):
        np.testing.assert_array_equal(aux[key].numpy(),
                                      np.asarray(jbaux[key]), err_msg=key)
    assert (aux["tri_id"].numpy() >= 0).mean() > 0.3
    assert (aux["forward_tri_id"].numpy() >= 0).any()
    np.testing.assert_allclose(aux["depth"].numpy(),
                               np.asarray(jbaux["depth"]), atol=1e-4)
    full, faux = render_frame(scene, view, meta, cfg)
    band, baux = render_rows(scene, view, meta, cfg, y0=y0, rows=rows,
                             full_frame=False,
                             shadowmap_override=faux["shadowmap"])
    assert torch.equal(band, full[y0:y0 + rows])
    for key in ("gbuffer_depth", "tri_id", "depth", "forward_tri_id"):
        assert torch.equal(baux[key], faux[key][y0:y0 + rows]), key
    odd, oaux = render_rows(scene, view, meta, cfg, y0=37, rows=21,
                            full_frame=False,
                            shadowmap_override=faux["shadowmap"])
    assert set(oaux["live_pairs"]) >= {"gbuffer"}  # the pair stream
    assert torch.equal(odd, full[37:58])
    assert torch.equal(oaux["tri_id"], faux["tri_id"][37:58])


@pytest.mark.parametrize("stripe", [True, False],
                         ids=["striped", "contiguous"])
def test_sharded_frame_matches_single_device(small, stripe):
    """``render_frame_sharded`` over ``[cpu] * 8`` against the JAX
    package's jitted single-device frame at tests/test_frame.py:129-130's
    bounds, and against the port's own full frame: equal (shadow map and
    visibility are the full frame's, bit for bit). The striped case through
    ``jit_sharded_renderer``; the contiguous one with band-sized compaction
    (a cap of 32 slots for the scene's 26 triangles), and again at 32-row
    tiles, where its 16-row bands start inside a tile row."""
    jscene, jview, jmeta, jcfg, scene, view, meta, cfg = small
    jimg = np.asarray(j_render(jscene, jview, jmeta, jcfg)[0])
    mesh = make_tile_mesh(CPU8)
    assert len(mesh.devices) == 8 and mesh.axis == "rows"
    if stripe:
        out = jit_sharded_renderer(meta, cfg, mesh)(scene, view)
    else:
        ccfg = cfg.replace(compact_tris=32)
        out = render_frame_sharded(scene, view, meta, ccfg, mesh,
                                   band_compact_slack=2.0, stripe=False)
    assert tuple(out.shape) == (cfg.height, cfg.width, 3)
    d = np.abs(out.numpy() - jimg).max(-1)
    assert d.max() < 0.15, d.max()
    assert (d > 1e-4).mean() < 0.05, (d > 1e-4).mean()
    full, _ = render_frame(scene, view, meta, cfg)
    assert torch.equal(out, full)
    if not stripe:
        tcfg = cfg.replace(tile_h=32)
        out = render_frame_sharded(scene, view, meta, tcfg, mesh,
                                   stripe=False)
        assert torch.equal(out, render_frame(scene, view, meta, tcfg)[0])


def test_sharded_meshlet_frame_with_68_lights(featured):
    """tests/test_frame.py:135-214's scene (meshlet cull and tiled light
    cull in every band): with shadows off at that test's bounds against the
    JAX package's jitted frame, with shadows at its shadow bounds; both
    equal to the port's own full frame. Both packages cull the lights to
    the same 8-row tiles here (``point_light_kernel="unroll"`` with 96
    slots: the tiled loop, the JAX package's CPU path); the port's "auto"
    culls to 40-row blocks, which a band starts at its own first row, so a
    band keeps other lists than the full frame under the 32-slot cap
    (ROADMAP.md §C)."""
    jscene, jview, jmeta, jcfg, scene, view, meta, cfg = featured
    mesh = make_tile_mesh(CPU8)
    for shadow, (dmax, frac) in ((False, (1e-3, 1e-3)), (True, (0.25, 0.12))):
        jc, pc = (c.replace(enable_shadow=shadow, point_light_kernel="unroll")
                  for c in (jcfg, cfg))
        jimg = np.asarray(j_render(jscene, jview, jmeta, jc)[0])
        out = render_frame_sharded(scene, view, meta, pc, mesh)
        d = np.abs(out.numpy() - jimg).max(-1)
        assert d.max() < dmax, (shadow, d.max())
        assert (d > 1e-4).mean() < frac, (shadow, (d > 1e-4).mean())
        assert torch.equal(out, render_frame(scene, view, meta, pc)[0])


def test_band_pair_stats_equal_the_jax_package(small):
    """Per device (band-live triangles, band pairs) over eight devices,
    striped and contiguous, against the JAX package's on its eight-device
    CPU mesh."""
    jscene, jview, jmeta, jcfg, scene, view, meta, cfg = small
    mesh = make_tile_mesh(CPU8)
    jmesh = jtiles.make_tile_mesh(jax.devices()[:8])
    for stripe in (True, False):
        got = band_pair_stats(scene, view, meta, cfg, mesh, stripe=stripe)
        want = jtiles.band_pair_stats(jscene, jview, jmeta, jcfg, jmesh,
                                      stripe=stripe)
        assert got.shape == (8, 2)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got[:, 1].sum() > 0


def test_pcf_backends_without_a_kernel_route_through_the_frame(small):
    """Each PCF backend without a kernel gives the frame of the exact
    filter ("exact") at every covered pixel, but "half_y4" (within one
    tap quantum on average); "packed_y8" on a map whose size is not a
    multiple of 8 falls back to the exact filter, as the JAX package's
    frame does."""
    _, _, _, _, scene, view, meta, cfg = small
    _, exact = render_frame(scene, view, meta,
                            cfg.replace(pcf_backend="exact"))
    cov = exact["tri_id"] >= 0
    ref = exact["shadow_factor"][cov]
    assert float(ref.min()) < float(ref.max())
    for backend in ("packed_y4", "packed_y8", "packed4", "packed8",
                    "packed16", "window1", "half_y4"):
        _, aux = render_frame(scene, view, meta,
                              cfg.replace(pcf_backend=backend))
        sf = aux["shadow_factor"][cov]
        if backend == "half_y4":
            assert float((sf - ref).abs().mean()) < 0.036
        else:
            assert torch.equal(sf, ref), backend
    odd = cfg.replace(shadowmap_dim=252)
    _, a = render_frame(scene, view, meta,
                        odd.replace(pcf_backend="packed_y8"))
    _, b = render_frame(scene, view, meta, odd.replace(pcf_backend="exact"))
    assert torch.equal(a["shadow_factor"], b["shadow_factor"])
