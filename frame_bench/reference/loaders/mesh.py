"""Mesh container and the procedural primitives the benchmark's worlds use.

Frozen from ``zeldaengine_tpu_torch/scene/mesh.py`` at commit fcd25b5:
``Mesh``, ``make_plane``, ``make_cube`` and ``make_sphere``, unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """CPU-side mesh (XkMesh, ZeldaEngine.cpp:671-687): SoA arrays."""

    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (V, 3) float32
    colors: np.ndarray  # (V, 3) float32
    uvs: np.ndarray  # (V, 2) float32
    indices: np.ndarray  # (T, 3) int32

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    def bounds(self):
        return self.positions.min(axis=0), self.positions.max(axis=0)


# ------------------------------------------------------------------ primitives


def make_plane(size: float = 1.0, z: float = 0.0, uv_scale: float = 1.0) -> Mesh:
    """A 2-triangle quad in the XY plane (Z-up world, like the stage mesh)."""
    s = size
    positions = np.array(
        [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]], np.float32
    )
    normals = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    colors = np.ones((4, 3), np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    indices = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return Mesh(positions, normals, colors, uvs, indices)


def make_cube(size: float = 1.0, center=(0.0, 0.0, 0.0)) -> Mesh:
    """Axis-aligned cube with per-face normals/uvs (24 verts, 12 tris)."""
    h = size / 2.0
    c = np.asarray(center, np.float32)
    faces = [
        # (normal, u-axis, v-axis)
        (np.array([1, 0, 0]), np.array([0, 1, 0]), np.array([0, 0, 1])),
        (np.array([-1, 0, 0]), np.array([0, -1, 0]), np.array([0, 0, 1])),
        (np.array([0, 1, 0]), np.array([-1, 0, 0]), np.array([0, 0, 1])),
        (np.array([0, -1, 0]), np.array([1, 0, 0]), np.array([0, 0, 1])),
        (np.array([0, 0, 1]), np.array([1, 0, 0]), np.array([0, 1, 0])),
        (np.array([0, 0, -1]), np.array([1, 0, 0]), np.array([0, -1, 0])),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for fi, (n, u, v) in enumerate(faces):
        n, u, v = (a.astype(np.float32) for a in (n, u, v))
        base = len(pos)
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            pos.append(c + h * (n + su * u + sv * v))
            nrm.append(n)
            uv.append([(su + 1) / 2, (sv + 1) / 2])
        # CCW when viewed from outside (right-handed)
        idx.append([base + 0, base + 1, base + 2])
        idx.append([base + 0, base + 2, base + 3])
    v_count = len(pos)
    return Mesh(
        positions=np.asarray(pos, np.float32),
        normals=np.asarray(nrm, np.float32),
        colors=np.ones((v_count, 3), np.float32),
        uvs=np.asarray(uv, np.float32),
        indices=np.asarray(idx, np.int32),
    )


def make_sphere(radius: float = 1.0, rings: int = 16, sectors: int = 32,
                inward: bool = False) -> Mesh:
    """UV sphere. ``inward=True`` flips winding + normals for skydome use
    (Content/Models/skydome.obj is an inside-out sphere)."""
    ring_t = np.linspace(0.0, np.pi, rings + 1)
    sec_t = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    pos, nrm, uv = [], [], []
    for i, theta in enumerate(ring_t):
        for j, phi in enumerate(sec_t):
            n = np.array(
                [
                    np.sin(theta) * np.cos(phi),
                    np.sin(theta) * np.sin(phi),
                    np.cos(theta),
                ],
                np.float32,
            )
            pos.append(n * radius)
            nrm.append(-n if inward else n)
            uv.append([j / sectors, i / rings])
    idx = []
    stride = sectors + 1
    for i in range(rings):
        for j in range(sectors):
            a = i * stride + j
            b = a + stride
            tri1 = [a, b, a + 1]
            tri2 = [a + 1, b, b + 1]
            if inward:
                tri1 = tri1[::-1]
                tri2 = tri2[::-1]
            idx.append(tri1)
            idx.append(tri2)
    v_count = len(pos)
    return Mesh(
        positions=np.asarray(pos, np.float32),
        normals=np.asarray(nrm, np.float32),
        colors=np.ones((v_count, 3), np.float32),
        uvs=np.asarray(uv, np.float32),
        indices=np.asarray(idx, np.int32),
    )
