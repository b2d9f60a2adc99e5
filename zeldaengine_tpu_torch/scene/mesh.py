"""Mesh container, OBJ loading with vertex dedup, and procedural primitives.

OBJ semantics match LoadMeshAsset (ZeldaEngine.cpp:6899-6948): triangulated
faces, vertex color = white, texcoord.v flipped (``1 - v``), and — matching a
reference quirk — normals are looked up with the *position* index
(``attrib.normals[3 * index.vertex_index]``), which is correct whenever the
OBJ has one normal per position (true for the bundled Content models).
Duplicate (pos, normal, color, uv) tuples are merged exactly like the
``unordered_map<XkVertex, uint32_t>`` dedup pass.
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


def load_obj(path: str, backend: str = "native") -> Mesh:
    """OBJ parser (v / vn / vt / f) with triangulation + dedup.

    ``backend``: "native" (the C++ loader of ``zeldaengine_tpu_torch.native``,
    built with g++ at first use; a failed build raises) or "python" (the
    plain parser below, the same semantics for OBJs whose (position, uv)
    index pairs name distinct vertices: the native loader dedups by index
    pair, this one by value)."""
    if backend == "native":
        from zeldaengine_tpu_torch.native import load_obj_native

        pos, nrm, uv, idx = load_obj_native(path)
        mesh = Mesh(positions=pos, normals=nrm,
                    colors=np.ones((pos.shape[0], 3), np.float32), uvs=uv,
                    indices=idx)
        if not np.abs(nrm).any():
            _compute_normals_inplace(mesh)
        return mesh
    if backend != "python":
        raise ValueError(f"backend={backend!r}: expected 'native' or "
                         "'python'")
    positions, normals, uvs = [], [], []
    face_tuples = []  # (vi, ti, ni) per corner
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vn "):
                parts = line.split()
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("f "):
                corners = []
                for token in line.split()[1:]:
                    comps = token.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    corners.append((vi, ti, ni))
                # fan-triangulate
                for k in range(1, len(corners) - 1):
                    face_tuples.append((corners[0], corners[k], corners[k + 1]))

    positions = np.asarray(positions, np.float32)
    normals_arr = np.asarray(normals, np.float32) if normals else None
    uvs_arr = np.asarray(uvs, np.float32) if uvs else None
    nv = len(positions)

    def _resolve(idx: int, count: int) -> int:
        return idx - 1 if idx > 0 else count + idx

    unique = {}
    out_pos, out_nrm, out_col, out_uv = [], [], [], []
    out_indices = []
    for tri in face_tuples:
        tri_idx = []
        for vi, ti, ni in tri:
            p_i = _resolve(vi, nv)
            pos = positions[p_i]
            # Reference quirk: normals addressed by the position index.
            if normals_arr is not None and p_i < len(normals_arr):
                nrm = normals_arr[p_i]
            elif normals_arr is not None and ni != 0:
                nrm = normals_arr[_resolve(ni, len(normals_arr))]
            else:
                nrm = np.zeros(3, np.float32)
            if uvs_arr is not None and ti != 0:
                t_i = _resolve(ti, len(uvs_arr))
                uv = np.array([uvs_arr[t_i][0], 1.0 - uvs_arr[t_i][1]], np.float32)
            else:
                uv = np.zeros(2, np.float32)
            key = (tuple(pos), tuple(nrm), (1.0, 1.0, 1.0), tuple(uv))
            if key not in unique:
                unique[key] = len(out_pos)
                out_pos.append(pos)
                out_nrm.append(nrm)
                out_col.append(np.ones(3, np.float32))
                out_uv.append(uv)
            tri_idx.append(unique[key])
        out_indices.append(tri_idx)

    mesh = Mesh(
        positions=np.asarray(out_pos, np.float32).reshape(-1, 3),
        normals=np.asarray(out_nrm, np.float32).reshape(-1, 3),
        colors=np.asarray(out_col, np.float32).reshape(-1, 3),
        uvs=np.asarray(out_uv, np.float32).reshape(-1, 2),
        indices=np.asarray(out_indices, np.int32).reshape(-1, 3),
    )
    if normals_arr is None:
        _compute_normals_inplace(mesh)
    return mesh


def load_mesh(path: str) -> Mesh:
    """Load a mesh by extension: .obj (tinyobjloader semantics) or .fbx
    (the binary-FBX reader of ``scene/fbx.py``; the reference's OpenFBX
    branch parses the file and builds no vertices)."""
    if path.lower().endswith(".fbx"):
        from zeldaengine_tpu_torch.scene.fbx import load_fbx

        return load_fbx(path)
    return load_obj(path)


def _compute_normals_inplace(mesh: Mesh) -> None:
    """Area-weighted vertex normals for meshes without vn records."""
    p = mesh.positions
    i0, i1, i2 = mesh.indices[:, 0], mesh.indices[:, 1], mesh.indices[:, 2]
    fn = np.cross(p[i1] - p[i0], p[i2] - p[i0])
    n = np.zeros_like(p)
    for k, idx in enumerate((i0, i1, i2)):
        np.add.at(n, idx, fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    mesh.normals = (n / np.maximum(lens, 1e-12)).astype(np.float32)


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


def save_obj(mesh: Mesh, path: str) -> None:
    """Write a Mesh as Wavefront OBJ (v/vt/vn + unified-index faces).

    The inverse of ``load_obj`` for position/uv/normal (OBJ has no
    vertex-color channel; colors reload as the all-ones default). Used
    by the textured-benchmark Profab generator and as a toolchain
    export — the reference ships OBJ content only
    (Content/Models/*.obj)."""
    with open(path, "w") as f:
        f.write("# zeldaengine_tpu_torch save_obj\n")
        for p in mesh.positions:
            f.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for t in mesh.uvs:
            f.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        for n in mesh.normals:
            f.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        for tri in np.asarray(mesh.indices, np.int64) + 1:
            f.write(f"f {tri[0]}/{tri[0]}/{tri[0]}"
                    f" {tri[1]}/{tri[1]}/{tri[1]}"
                    f" {tri[2]}/{tri[2]}/{tri[2]}\n")
