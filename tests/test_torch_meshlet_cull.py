"""The port's frustum + cone cull masks against the jitted JAX cull: on the
test meshes, on records placed within rounding of a plane, and at bench
config 4's full 14,004 records."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops.culling import meshlet_cull as j_meshlet_cull
from zeldaengine_tpu.passes import build_view_state as j_view
from zeldaengine_tpu.scene import world as j_world
from zeldaengine_tpu_torch import EngineConfig
from zeldaengine_tpu_torch import native
from zeldaengine_tpu_torch.meshlet import build_meshlets
from zeldaengine_tpu_torch.ops.culling import (
    _rows_times, frustum_planes, meshlet_cull)
from zeldaengine_tpu_torch.passes import build_view_state
from zeldaengine_tpu_torch.math.transforms import mat4_product
from zeldaengine_tpu_torch.scene import SceneBuilder, make_sphere
from zeldaengine_tpu_torch.scene import world as t_world

from _torch_meshlet_inputs import _MESHES

torch.set_num_threads(1)


_j_cull = jax.jit(j_meshlet_cull, static_argnames=("cone",))


def _model(roll):
    c, s = np.cos(np.float32(roll)), np.sin(np.float32(roll))
    m = np.eye(4, dtype=np.float32)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = [0.3, -0.2, 0.1]
    return m


@pytest.mark.parametrize("cone", [True, False])
@pytest.mark.parametrize("roll", [0.0, 0.37])
def test_cull_masks_equal_the_jitted_reference(cone, roll):
    """The test meshes' records beside 4,000 random ones, and the same
    records with each radius set to the distance of its nearest frustum
    plane (computed with the port's arithmetic, then nudged by -1, 0 or +1
    ulp), so that the sphere test is an equality within rounding: one
    rounding off in a plane distance, a norm, a dot product or a square
    root flips some of them."""
    rng = np.random.default_rng(11)
    rand = np.zeros((4000, 16), np.float32)
    rand[:, 4:7] = rng.uniform(-4.0, 4.0, (4000, 3))
    rand[:, 7] = rng.uniform(0.01, 0.5, 4000)
    axis = rng.normal(size=(4000, 3))
    rand[:, 11:14] = axis / np.linalg.norm(axis, axis=1, keepdims=True)
    rand[:, 14] = rng.uniform(0.0, 1.2, 4000)
    recs = np.concatenate([build_meshlets(*_MESHES[m]()[:2]).arrays()
                           for m in sorted(_MESHES)] + [rand])
    vp = (np.eye(4) + 0.3 * rng.normal(size=(4, 4))).astype(np.float32)
    cam = np.float32([2.5, -3.0, 1.5])
    model = _model(roll)
    t = torch.from_numpy
    centers = _rows_times(t(recs[:, 4:7]), t(model[:3, :3])) + t(model[:3, 3])
    planes = frustum_planes(t(vp))
    d = (_rows_times(centers, planes[:, :3]) + planes[None, :, 3]).numpy()
    edge = recs.copy()
    edge[:, 7] = np.maximum(-d.min(1), 1e-3)
    ulp = rng.integers(-1, 2, len(recs))
    edge[:, 7] = np.where(ulp == 0, edge[:, 7], np.nextafter(
        edge[:, 7], np.where(ulp > 0, np.float32(np.inf),
                             np.float32(-np.inf))))
    assert edge.dtype == np.float32
    for what, r in (("records", recs), ("on a plane", edge)):
        want = np.asarray(_j_cull(r, vp, cam, model, cone=cone))
        got = meshlet_cull(t(r), t(vp), t(cam), model=t(model), cone=cone)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        assert 0.01 < want.mean() < 0.99, (what, want.mean())


def _config4_world(mod):
    """bench.py:188-201's make_world for config 4, in ``mod``'s world
    types (either package's scene.world module)."""
    w = mod.World()
    w.main_camera = mod.CameraDesc(position=np.float32([6.0, -6.0, 3.0]),
                                   lookat=np.float32([0.0, 0.0, 0.8]),
                                   z_far=80.0)
    moon = np.float32([20.0, 0.0, 20.0])
    w.directional_lights = [mod.LightDesc(
        position=moon, type=0, color=np.float32([1.0, 0.95, 0.85]),
        intensity=3.0, direction=moon / np.linalg.norm(moon))]
    return w


def test_config4_cull_at_full_scale():
    """Bench config 4 (bench.py:254-334) baked by the port's native builder:
    1,030,400 triangles in 14,004 meshlets; at time 0 the camera cull keeps
    6,301 and the light cull (shadow_cone_cull) 8,078, bit for bit with the
    jitted JAX cull on the same records and the JAX package's matrices."""
    config = EngineConfig(
        width=1024, height=1024, shadowmap_dim=512, texture_size=128,
        cubemap_size=64, background_size=128, max_point_lights=8,
        pair_expand=4, pair_expand_shadow=2, compact_tris=384 * 1024,
        compact_tris_shadow=96 * 1024, shadow_cone_cull=True,
        subpixel_cull=True, max_pairs=384 * 1024, max_pairs_shadow=64 * 1024)
    b = SceneBuilder(config)
    mat = b.add_material({})
    mesh = make_sphere(0.8, rings=140, sectors=230)
    for i in range(16):
        offs = np.float32([(i % 4 - 1.5) * 2.2, (i // 4 - 1.5) * 2.2, 0.8])
        b.add_meshlet_object(build_meshlets(
            mesh.positions + offs, mesh.indices, normals=mesh.normals,
            uvs=mesh.uvs), mat)
    scene, meta = b.build("cpu")
    assert (meta.num_triangles, meta.num_meshlets) == (1030400, 14004)
    view = build_view_state(_config4_world(t_world), config, time=0.0,
                            device="cpu")
    jview = j_view(_config4_world(j_world), config, time=0.0)
    for name in ("view_proj", "shadow_space", "model", "camera_pos",
                 "dir_lights"):
        np.testing.assert_array_equal(getattr(view, name).numpy(),
                                      np.asarray(getattr(jview, name)),
                                      err_msg=name)
    recs = scene.meshlet_records
    j_product = jax.jit(lambda a, b: jnp.matmul(
        a, b, precision=jax.lax.Precision.HIGHEST))
    kept = {}
    for what, vp, jvp, eye, cone in (
            ("camera", view.view_proj, jview.view_proj, view.camera_pos,
             True),
            ("shadow", view.shadow_space, jview.shadow_space,
             view.dir_lights[0, 0, :3], config.shadow_cone_cull)):
        got = meshlet_cull(recs, mat4_product(vp, view.model), eye,
                           model=view.model, cone=cone).numpy()
        want = np.asarray(_j_cull(recs.numpy(),
                                  j_product(jvp, jview.model),
                                  eye.numpy(), jview.model, cone=cone))
        np.testing.assert_array_equal(got, want, err_msg=what)
        kept[what] = int(got.sum())
    assert kept == {"camera": 6301, "shadow": 8078}
