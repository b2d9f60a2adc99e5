"""Meshlet building - the ZeldaMeshlet toolkit (meshopt_buildMeshlets /
meshopt_computeMeshletBounds, ZeldaMeshlet.cpp:132-171).

Meshlets of <= max_vertices unique vertices and <= max_triangles triangles,
each with a bounding sphere and a backface cone (apex, axis, cutoff) for
the per-frame cull (``ops/culling.py``). The clusterizer is the native C++
one (``zeldaengine_tpu_torch.native``); the greedy NumPy clusterizer below
is its plain version (``backend="numpy"``): the same meshlets, other bounds
(Ritter's sphere and the cone are computed in another precision and
order), so the two are never mixed in one comparison.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

MAX_VERTICES_DEFAULT = 64
MAX_TRIANGLES_DEFAULT = 124
_BACKENDS = ("native", "numpy")


@dataclasses.dataclass
class Meshlet:
    """Mirrors ZeldaMeshlet.cpp:39-49 / XkMeshlet (ZeldaEngine.cpp:689)."""

    vertex_offset: int
    vertex_count: int
    triangle_offset: int  # byte offset into meshlet_triangles (3 per tri)
    triangle_count: int
    bounds_center: np.ndarray  # (3,)
    bounds_radius: float
    cone_apex: np.ndarray  # (3,)
    cone_axis: np.ndarray  # (3,)
    cone_cutoff: float


@dataclasses.dataclass
class MeshletSet:
    """Mirrors MeshletSet (ZeldaMeshlet.cpp:51-122): 5 arrays."""

    meshlets: List[Meshlet]
    meshlet_vertices: np.ndarray  # (NV,) uint32 -> global vertex ids
    meshlet_triangles: np.ndarray  # (NT*3,) uint8 meshlet-local indices
    vertices: np.ndarray  # (V, 8) float32: x,y,z, nx,ny,nz, u,v
    indices: np.ndarray  # (I,) uint32 original index buffer

    def arrays(self):
        """Flat numpy arrays for device upload: (M, 16) float32 records
        [v_off, v_cnt, t_off, t_cnt, center(3), radius, apex(3), axis(3),
        cutoff, pad]."""
        recs = np.zeros((len(self.meshlets), 16), np.float32)
        for i, m in enumerate(self.meshlets):
            recs[i, 0] = m.vertex_offset
            recs[i, 1] = m.vertex_count
            recs[i, 2] = m.triangle_offset
            recs[i, 3] = m.triangle_count
            recs[i, 4:7] = m.bounds_center
            recs[i, 7] = m.bounds_radius
            recs[i, 8:11] = m.cone_apex
            recs[i, 11:14] = m.cone_axis
            recs[i, 14] = m.cone_cutoff
        return recs


def meshlet_from_record(r) -> Meshlet:
    """A ``Meshlet`` from one 64-byte record (``native.MESHLET_REC``)."""
    return Meshlet(
        vertex_offset=int(r["vertex_offset"]),
        vertex_count=int(r["vertex_count"]),
        triangle_offset=int(r["triangle_offset"]),
        triangle_count=int(r["triangle_count"]),
        bounds_center=np.asarray(r["bounds_center"], np.float32),
        bounds_radius=float(r["bounds_radius"]),
        cone_apex=np.asarray(r["cone_apex"], np.float32),
        cone_axis=np.asarray(r["cone_axis"], np.float32),
        cone_cutoff=float(r["cone_cutoff"]),
    )


def _bounding_sphere(points: np.ndarray):
    """Ritter's bounding sphere (matches meshopt's approach closely)."""
    if len(points) == 0:
        return np.zeros(3, np.float32), 0.0
    # start from extreme points along the largest-extent axis
    mins = points.argmin(axis=0)
    maxs = points.argmax(axis=0)
    best_axis = (points[maxs] - points[mins]).__pow__(2).sum(axis=1).argmax()
    p1, p2 = points[mins[best_axis]], points[maxs[best_axis]]
    center = (p1 + p2) / 2.0
    radius = np.linalg.norm(p2 - p1) / 2.0
    for p in points:
        d = np.linalg.norm(p - center)
        if d > radius:
            # grow sphere
            new_r = (radius + d) / 2.0
            center = center + (p - center) * ((new_r - radius) / d)
            radius = new_r
    return center.astype(np.float32), float(radius)


def _compute_bounds(positions, mv, mt, count):
    """meshopt_computeMeshletBounds semantics (ZeldaMeshlet.cpp:151-166)."""
    tris = mt[: count * 3].reshape(-1, 3)
    vids = mv[tris]  # (count, 3) global vertex ids
    pts = positions[np.unique(vids)]
    center, radius = _bounding_sphere(pts)

    p0 = positions[vids[:, 0]]
    p1 = positions[vids[:, 1]]
    p2 = positions[vids[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(lens, 1e-20)
    axis = n.sum(axis=0)
    alen = np.linalg.norm(axis)
    if alen < 1e-12:
        # degenerate spread: cutoff 1 => never backface-culled
        return center, radius, center.copy(), np.zeros(3, np.float32), 1.0
    axis = axis / alen
    mindot = float(np.min(n @ axis))
    cutoff = float(np.sqrt(1.0 - mindot * mindot)) if mindot > 0.0 else 1.0
    return center, radius, center.copy(), axis.astype(np.float32), cutoff


def _morton_order(positions, tris):
    """Triangles in Morton order of their centroids (10 bits an axis)."""
    cent = positions[tris].mean(axis=1)
    lo, hi = cent.min(0), cent.max(0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return tris[np.argsort(morton)]


def _greedy_meshlets(positions, tris, max_vertices, max_triangles):
    """The plain clusterizer: (meshlets, meshlet_vertices, meshlet_triangles)
    by one greedy pass in triangle order."""
    meshlets: List[Meshlet] = []
    mv: List[int] = []  # global vertex ids
    mt: List[int] = []  # local byte indices
    cur_map = {}
    cur_tris = 0
    cur_voff = 0
    cur_toff = 0

    def flush():
        nonlocal cur_map, cur_tris, cur_voff, cur_toff
        if cur_tris == 0:
            return
        center, radius, apex, axis, cutoff = _compute_bounds(
            positions,
            np.asarray(mv[cur_voff:], np.uint32),
            np.asarray(mt[cur_toff:], np.uint8),
            cur_tris,
        )
        meshlets.append(Meshlet(
            vertex_offset=cur_voff, vertex_count=len(cur_map),
            triangle_offset=cur_toff, triangle_count=cur_tris,
            bounds_center=center, bounds_radius=radius, cone_apex=apex,
            cone_axis=axis, cone_cutoff=cutoff))
        cur_voff = len(mv)
        cur_toff = len(mt)
        cur_map = {}
        cur_tris = 0

    for tri in tris:
        new_verts = sum(1 for v in tri if int(v) not in cur_map)
        if (
            len(cur_map) + new_verts > max_vertices
            or cur_tris + 1 > max_triangles
        ):
            flush()
        for v in tri:
            v = int(v)
            if v not in cur_map:
                cur_map[v] = len(cur_map)
                mv.append(v)
            mt.append(cur_map[v])
        cur_tris += 1
    flush()
    return (meshlets, np.asarray(mv, np.uint32), np.asarray(mt, np.uint8))


def build_meshlets(
    positions: np.ndarray,
    indices: np.ndarray,
    max_vertices: int = MAX_VERTICES_DEFAULT,
    max_triangles: int = MAX_TRIANGLES_DEFAULT,
    normals: np.ndarray | None = None,
    uvs: np.ndarray | None = None,
    spatial_sort: bool = True,
    backend: str = "native",
) -> MeshletSet:
    """Clusterize triangles into meshlets.

    Triangles are optionally Morton-ordered by centroid first so greedy
    packing yields spatially compact clusters (the property the cone/sphere
    culling relies on, standing in for meshopt's cone-weighted scoring).
    ``backend``: "native" (the C++ clusterizer; building it raises if g++
    fails) or "numpy" (the plain version).
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {_BACKENDS}")
    positions = np.asarray(positions, np.float32)
    tris = np.asarray(indices, np.uint32).reshape(-1, 3)
    if backend == "native":
        from zeldaengine_tpu_torch.native import build_meshlets_native

        recs, mv_arr, mt_arr = build_meshlets_native(
            positions, tris, max_vertices=max_vertices,
            max_triangles=max_triangles, spatial_sort=spatial_sort)
        meshlets = [meshlet_from_record(r) for r in recs]
    else:
        if spatial_sort and len(tris) > 1:
            tris = _morton_order(positions, tris)
        meshlets, mv_arr, mt_arr = _greedy_meshlets(
            positions, tris, max_vertices, max_triangles)

    v = positions
    n = normals if normals is not None else np.zeros_like(v)
    t = uvs if uvs is not None else np.zeros((len(v), 2), np.float32)
    verts8 = np.concatenate([v, n, t], axis=1).astype(np.float32)
    return MeshletSet(
        meshlets=meshlets,
        meshlet_vertices=mv_arr,
        meshlet_triangles=mt_arr,
        vertices=verts8,
        indices=np.asarray(indices, np.uint32).reshape(-1),
    )
