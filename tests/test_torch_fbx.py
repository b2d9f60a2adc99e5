"""The port's binary-FBX reader and writer (``scene/fbx.py``) against the
JAX package's: a file written by the JAX package loads in the port to the
arrays the JAX package loads (exactly: the same NumPy code on the same
bytes), and the port's writer produces the JAX writer's bytes (version
7400)."""

import struct
import zlib

import numpy as np
import pytest

from zeldaengine_tpu.scene import fbx as jfbx
from zeldaengine_tpu.scene import mesh as jmesh
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.scene import fbx as tfbx
from zeldaengine_tpu_torch.scene import mesh as tmesh
from zeldaengine_tpu_torch.scene.assets import load_profab
from zeldaengine_tpu_torch.scene.scenebuild import SceneBuilder

FIELDS = ("positions", "normals", "colors", "uvs", "indices")


def _port_mesh(m):
    return tmesh.Mesh(**{f: np.array(getattr(m, f)) for f in FIELDS})


def _assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("shape", ["cube", "sphere"])
def test_jax_written_file_loads_to_the_same_arrays(tmp_path, shape):
    """Cube, and sphere with its normals and uvs (ByPolygonVertex normals,
    IndexToDirect uvs, flipped v)."""
    mesh = (jmesh.make_cube(1.0) if shape == "cube"
            else jmesh.make_sphere(1.0, rings=8, sectors=12))
    path = str(tmp_path / f"{shape}.fbx")
    jfbx.save_fbx(path, mesh)
    want = jfbx.load_fbx(path)
    got = tfbx.load_fbx(path)
    _assert_same(got, want)
    _assert_same(tmesh.load_mesh(path), want)
    assert got.num_triangles == mesh.num_triangles
    if shape == "sphere":
        radial = np.abs(np.sum(got.normals * got.positions, -1))
        assert radial.mean() > 0.9


def test_writer_bytes_equal_to_jax(tmp_path):
    for i, mesh in enumerate((jmesh.make_cube(1.0),
                              jmesh.make_sphere(0.7, rings=6, sectors=9))):
        jpath, tpath = tmp_path / f"j{i}.fbx", tmp_path / f"t{i}.fbx"
        jfbx.save_fbx(str(jpath), mesh)
        tfbx.save_fbx(str(tpath), _port_mesh(mesh))
        data = tpath.read_bytes()
        assert data == jpath.read_bytes()
        assert struct.unpack_from("<I", data, 23)[0] == 7400


def test_compressed_array_property(tmp_path):
    """A zlib-compressed array property decodes to the array."""
    path = str(tmp_path / "c.fbx")
    tfbx.save_fbx(path, _port_mesh(jmesh.make_cube(1.0)))
    with open(path, "rb") as f:
        root = tfbx.parse_fbx(f.read())
    arr = root.find("Objects").find_all("Geometry")[0].find("Vertices").prop(0)
    raw = np.asarray(arr, np.float64).tobytes()
    comp = zlib.compress(raw)
    blob = b"d" + struct.pack("<III", len(arr), 1, len(comp)) + comp
    val, end = tfbx._read_property(memoryview(blob), 0)
    np.testing.assert_array_equal(val, arr)
    assert end == len(blob)
    jval, _ = jfbx._read_property(memoryview(blob), 0)
    np.testing.assert_array_equal(val, jval)


def test_quad_polygons_triangulate_like_jax():
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [2, 0, 0]], np.float64)
    pvi = np.array([0, 1, 2, ~3, 1, 4, ~2], np.int64)  # a quad, a triangle

    def geo(mod):
        return mod.FbxNode("Geometry", [1, "Mesh::q", "Mesh"], [
            mod.FbxNode("Vertices", [verts.reshape(-1)], []),
            mod.FbxNode("PolygonVertexIndex", [pvi], []),
        ])

    got = tfbx.geometry_to_mesh(geo(tfbx))
    assert got.num_triangles == 3 and got.num_vertices == 5
    _assert_same(got, jfbx.geometry_to_mesh(geo(jfbx)))


def test_ascii_fbx_rejected(tmp_path):
    p = tmp_path / "a.fbx"
    p.write_bytes(b"; FBX 7.4.0 project file\nFBXHeaderExtension: {}\n")
    with pytest.raises(ValueError, match="ASCII"):
        tfbx.load_fbx(str(p))
    with pytest.raises(ValueError, match="ASCII"):
        tmesh.load_mesh(str(p))


def test_profab_discovery_accepts_fbx(tmp_path):
    """An .fbx under Profabs/<name>/models loads through the port's
    Profab scanner into its scene build."""
    mdir = tmp_path / "Profabs" / "thing" / "models"
    (tmp_path / "Profabs" / "thing" / "textures").mkdir(parents=True)
    mdir.mkdir(parents=True)
    tfbx.save_fbx(str(mdir / "thing.fbx"), _port_mesh(jmesh.make_cube(1.0)))
    b = SceneBuilder(TEST_CONFIG)
    assert load_profab(b, "thing", [str(tmp_path)], None, deferred=True)
    _, meta = b.build("cpu")
    assert meta.num_triangles == 12
