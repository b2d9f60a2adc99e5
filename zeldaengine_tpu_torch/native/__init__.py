"""Native (C++) host-side components, bound via ctypes.

``zeldanative.cpp`` is the JAX package's native library, copied whole: the
greedy meshlet clusterizer with its bounding spheres and backface cones
(``ze_build_meshlets``, which Morton-sorts the triangles first), that sort
alone (``ze_morton_sort_triangles``) and the OBJ loader (``ze_load_obj``).

It is built with g++ at first use, with the JAX package's own command
(``-O3 -march=native -shared -fPIC -std=c++17``), so that the bounds it
computes are the same bits as that package's native ones on the same
machine (``-march=native`` decides whether g++ contracts multiply-adds).
The library goes to ``zeldaengine_tpu_torch/_build/native-<hash of the
source, the command and the target g++ resolves -march=native to>/``,
written under a temporary name and renamed, so that processes building at
the same moment agree. Nothing is built at
import time. A failed build raises: there is no silent NumPy fallback,
because the NumPy clusterizer (``meshlet/build.py``, the plain version)
computes other bounds, and the bounds decide the cull.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "zeldanative.cpp"
BUILD_ROOT = _HERE.parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib = None


class _ZeObjData(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("indices", ctypes.POINTER(ctypes.c_uint32)),
        ("n_verts", ctypes.c_int64),
        ("n_tris", ctypes.c_int64),
    ]


def library_path() -> Path:
    """Where the library of this source, command and host CPU lives (what
    ``-march=native`` selects goes into the key, so that a checkout shared
    by two machines keeps one library for each)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(["g++", *CXX_FLAGS]).encode())
    try:
        target = subprocess.run(["g++", "-march=native", "-Q",
                                 "--help=target"], capture_output=True,
                                text=True).stdout
    except FileNotFoundError:
        target = ""  # build() reports the missing compiler
    h.update(target.encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libzeldanative.so"


def build() -> Path:
    """Compile the library unless this source was built with this command
    before; return its path. Raises when g++ is missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"tmp{os.getpid()}-{lib.name}"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            "zeldaengine_tpu_torch.native: g++ not found; the meshlet "
            "clusterizer and OBJ loader are built from zeldanative.cpp at "
            "first use") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed for zeldanative.cpp\n" + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builds agree on content
    return lib


def load() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ze_build_meshlets.restype = ctypes.c_int64
    lib.ze_build_meshlets.argtypes = [
        f32p, ctypes.c_int64, u32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, u32p, ctypes.POINTER(ctypes.c_uint8), i64p, i64p,
    ]
    lib.ze_morton_sort_triangles.restype = None
    lib.ze_morton_sort_triangles.argtypes = [
        f32p, ctypes.c_int64, u32p, ctypes.c_int64, u32p]
    lib.ze_load_obj.restype = ctypes.c_int32
    lib.ze_load_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ZeObjData)]
    lib.ze_free_obj.restype = None
    lib.ze_free_obj.argtypes = [ctypes.POINTER(_ZeObjData)]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is loaded (``load()`` builds it, or raises)."""
    return _lib is not None


MESHLET_REC = np.dtype(
    [
        ("vertex_offset", "<u4"),
        ("vertex_count", "<u4"),
        ("triangle_offset", "<u4"),
        ("triangle_count", "<u4"),
        ("bounds_center", "<f4", 3),
        ("bounds_radius", "<f4"),
        ("cone_apex", "<f4", 3),
        ("cone_axis", "<f4", 3),
        ("cone_cutoff", "<f4"),
        ("pad", "<f4"),
    ]
)
assert MESHLET_REC.itemsize == 64


def _indices(indices) -> np.ndarray:
    idx = np.ascontiguousarray(indices, np.uint32).reshape(-1)
    if idx.shape[0] % 3:
        raise ValueError(f"{idx.shape[0]} indices are not whole triangles")
    return idx


def build_meshlets_native(positions: np.ndarray, indices: np.ndarray,
                          max_vertices: int = 64, max_triangles: int = 124,
                          spatial_sort: bool = True):
    """(records structured array, meshlet_vertices u32, meshlet_triangles
    u8) from the native clusterizer."""
    if not (3 <= max_vertices <= 256 and max_triangles >= 1):
        raise ValueError(f"max_vertices={max_vertices} (8-bit local "
                         f"indices: 3..256), max_triangles={max_triangles}")
    lib = load()
    pos = np.ascontiguousarray(positions, np.float32).reshape(-1, 3)
    idx = _indices(indices)
    if idx.size and int(idx.max()) >= pos.shape[0]:
        raise ValueError("an index exceeds the vertex count")
    n_tris = idx.shape[0] // 3
    recs = np.zeros(max(n_tris, 1), MESHLET_REC)
    mv = np.zeros(max(n_tris * 3, 1), np.uint32)
    mt = np.zeros(max(n_tris * 3, 1), np.uint8)
    mv_count = ctypes.c_int64()
    mt_count = ctypes.c_int64()
    n = lib.ze_build_meshlets(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pos.shape[0],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_tris,
        max_vertices, max_triangles, 1 if spatial_sort else 0,
        recs.ctypes.data,
        mv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        mt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(mv_count), ctypes.byref(mt_count),
    )
    return (recs[:n].copy(), mv[: mv_count.value].copy(),
            mt[: mt_count.value].copy())


def morton_sort_triangles_native(positions: np.ndarray,
                                 indices: np.ndarray) -> np.ndarray:
    """The triangles of ``indices`` reordered by the Morton code of their
    centroids (``ze_morton_sort_triangles``): (T, 3) uint32."""
    lib = load()
    pos = np.ascontiguousarray(positions, np.float32).reshape(-1, 3)
    idx = _indices(indices)
    if idx.size and int(idx.max()) >= pos.shape[0]:
        raise ValueError("an index exceeds the vertex count")
    out = np.zeros_like(idx)
    lib.ze_morton_sort_triangles(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pos.shape[0],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        idx.shape[0] // 3,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out.reshape(-1, 3)


def load_obj_native(path: str):
    """(positions, normals, uvs, indices) of an OBJ file. Raises when the
    file cannot be read."""
    lib = load()
    data = _ZeObjData()
    rc = lib.ze_load_obj(os.fsencode(path), ctypes.byref(data))
    if rc != 0:
        raise OSError(f"ze_load_obj could not read {path!r} (code {rc})")
    try:
        nv, nt = data.n_verts, data.n_tris
        pos = np.ctypeslib.as_array(data.positions, (nv, 3)).copy()
        nrm = np.ctypeslib.as_array(data.normals, (nv, 3)).copy()
        uv = np.ctypeslib.as_array(data.uvs, (nv, 2)).copy()
        idx = np.ctypeslib.as_array(data.indices, (nt, 3)).astype(np.int32)
    finally:
        lib.ze_free_obj(ctypes.byref(data))
    return pos, nrm, uv, idx
