"""The port's meshlet tooling against the JAX package's, bit for bit: the
native clusterizer (both packages' copies of zeldanative.cpp, built with
the same g++ command) and the NumPy clusterizer, the .meshlet files and the
meshletgen CLI, the OBJ loaders, and the frustum + cone cull masks against
the jitted JAX cull (on the test meshes, on records placed within rounding
of a plane, and at bench config 4's full 14,004 records)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zeldaengine_tpu.native as j_native
from zeldaengine_tpu.meshlet import build_meshlets as j_build_meshlets
from zeldaengine_tpu.meshlet import load_meshlet_set as j_load
from zeldaengine_tpu.meshlet import save_meshlet_set as j_save
from zeldaengine_tpu.ops.culling import meshlet_cull as j_meshlet_cull
from zeldaengine_tpu.passes import build_view_state as j_view
from zeldaengine_tpu.scene import world as j_world
from zeldaengine_tpu.scene.mesh import load_obj as j_load_obj
from zeldaengine_tpu.tools.meshletgen import main as j_meshletgen
from zeldaengine_tpu_torch import EngineConfig
from zeldaengine_tpu_torch import native
from zeldaengine_tpu_torch.meshlet import (
    build_meshlets, load_meshlet_set, save_meshlet_set)
from zeldaengine_tpu_torch.ops.culling import (
    _rows_times, frustum_planes, meshlet_cull)
from zeldaengine_tpu_torch.passes import build_view_state
from zeldaengine_tpu_torch.math.transforms import mat4_product
from zeldaengine_tpu_torch.scene import SceneBuilder, make_sphere
from zeldaengine_tpu_torch.scene import world as t_world
from zeldaengine_tpu_torch.scene.mesh import load_obj
from zeldaengine_tpu_torch.tools.meshletgen import main as meshletgen

torch.set_num_threads(1)

_j_cull = jax.jit(j_meshlet_cull, static_argnames=("cone",))


def _soup(seed=3, n=700):
    """Random triangles over 300 shared vertices."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (300, 3)).astype(np.float32)
    return pos, rng.integers(0, 300, (n, 3)).astype(np.int32)


# mesh -> (positions, indices, build_meshlets keywords)
_MESHES = {
    "sphere-40x60": lambda: (*_sphere(0.8, 40, 60), {}),
    "sphere-12x16-v32-t40": lambda: (*_sphere(0.5, 12, 16),
                                     dict(max_vertices=32, max_triangles=40)),
    "soup-unsorted": lambda: (*_soup(), dict(spatial_sort=False)),
}


def _sphere(r, rings, sectors):
    m = make_sphere(r, rings=rings, sectors=sectors)
    return m.positions, m.indices


def _set_arrays(ms):
    return dict(records=ms.arrays(), meshlet_vertices=ms.meshlet_vertices,
                meshlet_triangles=ms.meshlet_triangles,
                vertices=ms.vertices, indices=ms.indices)


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_builders_match_the_reference_bit_for_bit(mesh, backend,
                                                  monkeypatch):
    """The native builders of both packages (each built from its own copy
    of the source with the same command) agree bit for bit, and so do the
    NumPy builders; the two builders are never compared with each other
    (their bounds differ)."""
    pos, idx, kw = _MESHES[mesh]()
    if backend == "numpy":
        # The JAX package takes its NumPy path only when the native one
        # gives nothing.
        monkeypatch.setattr(j_native, "build_meshlets_native",
                            lambda *a, **k: None)
    else:
        native.load()
        assert native.available() and j_native.available()
        assert native.CXX_FLAGS == ["-O3", "-march=native", "-shared",
                                    "-fPIC", "-std=c++17"]
        assert native.library_path().parent.parent == native.BUILD_ROOT
    want = _set_arrays(j_build_meshlets(pos, idx, **kw))
    got = _set_arrays(build_meshlets(pos, idx, backend=backend, **kw))
    assert want["records"].shape[0] > 4
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def _obj_text(quads: bool) -> str:
    """A 4x3 grid of v/vt/vn quads (or the same grid as triangles), each
    position with its own uv and normal."""
    lines = []
    for j in range(4):
        for i in range(5):
            lines.append(f"v {i * 0.5:.4f} {j * 0.25:.4f} {0.1 * i * j:.4f}")
            lines.append(f"vt {i / 4:.4f} {j / 3:.4f}")
            lines.append(f"vn 0.0 {0.1 * i:.4f} 1.0")
    for j in range(3):
        for i in range(4):
            a, b = j * 5 + i + 1, j * 5 + i + 2
            c, d = b + 5, a + 5
            if quads:
                lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c} "
                             f"{d}/{d}/{d}")
            else:
                lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
                lines.append(f"f {a}/{a}/{a} {c}/{c}/{c} {d}/{d}/{d}")
    return "\n".join(lines) + "\n"


_BARE = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 2 0 0.5\nf 1 2 3 4\nf 2 5 3\n"


@pytest.mark.parametrize("text", ["grid-quads", "grid-triangles", "bare"])
def test_load_obj_native_equals_python_and_the_reference(tmp_path, text):
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write({"grid-quads": _obj_text(True),
                 "grid-triangles": _obj_text(False), "bare": _BARE}[text])
    got = load_obj(path)
    plain = load_obj(path, backend="python")
    want = j_load_obj(path)
    assert got.num_triangles == {"bare": 3}.get(text, 24)
    for name in ("positions", "normals", "uvs", "colors", "indices"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(plain, name), err_msg=name)
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    with pytest.raises(OSError):
        load_obj(str(tmp_path / "missing.obj"))
    with pytest.raises(ValueError, match="backend"):
        load_obj(path, backend="fast")


def test_meshlet_files_and_meshletgen_equal_the_reference(tmp_path):
    """Files cross-read between the packages and rewritten are the same
    bytes; the two meshletgen CLIs write the same bytes from one OBJ."""
    pos, idx = _sphere(0.8, 20, 30)
    ms = build_meshlets(pos, idx)
    a, b = str(tmp_path / "a.meshlet"), str(tmp_path / "b.meshlet")
    save_meshlet_set(a, ms)
    j_save(b, j_load(a))
    save_meshlet_set(str(tmp_path / "c.meshlet"), load_meshlet_set(b))
    blobs = [open(str(tmp_path / n), "rb").read()
             for n in ("a.meshlet", "b.meshlet", "c.meshlet")]
    assert blobs[0] == blobs[1] == blobs[2]
    back = load_meshlet_set(a)
    np.testing.assert_array_equal(back.arrays(), ms.arrays())
    with open(a, "rb") as f:
        head = f.read(100)
    cut = str(tmp_path / "cut.meshlet")
    with open(cut, "wb") as f:
        f.write(head)
    with pytest.raises(ValueError, match="truncated"):
        load_meshlet_set(cut)

    obj = str(tmp_path / "grid.obj")
    with open(obj, "w") as f:
        f.write(_obj_text(True))
    outs = []
    for name, cli in (("port", meshletgen), ("jax", j_meshletgen)):
        out = str(tmp_path / f"{name}.meshlet")
        assert cli(["-i", obj, "-o", out, "-v", "16", "-t", "8"]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and len(outs[0]) > 64


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
