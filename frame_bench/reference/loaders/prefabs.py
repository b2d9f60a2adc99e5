"""A world's objects as meshes and instances, as the engine's scene build
reads them (``zeldaengine_tpu_torch/scene/assets.py::load_profab`` and
``scene/scenebuild.py::SceneBuilder.add_object`` at commit fcd25b5).

The benchmark's worlds name prefabs that have no assets on disk, so each
object is its procedural stand-in mesh with the default material; grass
is two-sided. Instances are staged as ``p' = R^T (s p) + t`` with normals
``R^T n``, R the instance's ``MakeRotMatrix``.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from frame_bench.reference.loaders.mesh import (
    Mesh, make_cube, make_plane, make_sphere)
from frame_bench.reference.loaders.world import RenderFlags, World


def procedural_mesh(name: str) -> Mesh:
    """The stand-in mesh of a prefab with no assets (assets.py,
    ``_procedural_profab_build``)."""
    if "terrain" in name or "stage" in name:
        return make_plane(10.0, uv_scale=8.0)
    if "rock" in name:
        return make_sphere(0.4, rings=6, sectors=9)
    if "grass" in name:
        # two crossed quads standing in Z (billboard-ish grass card)
        quads = []
        base = make_plane(0.5)
        for rot in (0.0, np.pi / 2):
            m = base
            c, s = np.cos(rot), np.sin(rot)
            r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            # stand the quad up: xy plane -> xz plane
            stand = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
            pos = (m.positions @ stand.T + np.array([0, 0, 0.5], np.float32)) @ r.T
            nrm = (m.normals @ stand.T) @ r.T
            quads.append((pos.astype(np.float32), nrm.astype(np.float32),
                          m.uvs, m.indices))
        n0 = quads[0][0].shape[0]
        return Mesh(
            positions=np.concatenate([q[0] for q in quads]),
            normals=np.concatenate([q[1] for q in quads]),
            colors=np.ones((2 * n0, 3), np.float32),
            uvs=np.concatenate([q[2] for q in quads]),
            indices=np.concatenate([quads[0][3], quads[1][3] + n0]),
        )
    if "sphere" in name:
        return make_sphere(0.5)
    return make_cube(1.0)


def rot_matrix(r3: np.ndarray) -> np.ndarray:
    """MakeRotMatrix (Common.glsl:60-87): r3 (..., 3) -> (..., 3, 3)."""
    sx, cx = np.sin(r3[..., 0]), np.cos(r3[..., 0])
    sy, cy = np.sin(r3[..., 1]), np.cos(r3[..., 1])
    sz, cz = np.sin(r3[..., 2]), np.cos(r3[..., 2])
    z = np.zeros_like(sx)
    o = np.ones_like(sx)
    mx = np.stack([cx, z, -sx, z, o, z, sx, z, cx], -1).reshape(*sx.shape, 3, 3)
    my = np.stack([cy, -sy, z, sy, cy, z, z, z, o], -1).reshape(*sx.shape, 3, 3)
    mz = np.stack([o, z, z, z, cz, -sz, z, sz, cz], -1).reshape(*sx.shape, 3, 3)
    return mz @ my @ mx


class Part(NamedTuple):
    """One object's triangles: staged float64 vertices and its flags."""

    positions: np.ndarray  # (V, 3) world positions before the model matrix
    normals: np.ndarray  # (V, 3)
    uvs: np.ndarray  # (V, 2)
    indices: np.ndarray  # (T, 3) into this part's vertices
    two_sided: bool
    deferred: bool


def stage(mesh: Mesh, instances, two_sided: bool, deferred: bool) -> Part:
    """A mesh, once or at each of ``instances`` ((N, 8): position,
    rotation, scale, texture index), in float64."""
    p = mesh.positions.astype(np.float64)
    n = mesh.normals.astype(np.float64)
    n = n / np.sqrt(np.maximum((n * n).sum(-1, keepdims=True), 1e-20))
    if instances is None:
        pos, nrm, reps = p, n, 1
    else:
        inst = np.asarray(instances, np.float64)
        rt = np.swapaxes(rot_matrix(inst[:, 3:6]), -1, -2)  # R^T
        pos = (np.einsum("nij,vj->nvi", rt, p) * inst[:, None, 6:7]
               + inst[:, None, :3]).reshape(-1, 3)
        nrm = np.einsum("nij,vj->nvi", rt, n).reshape(-1, 3)
        reps = inst.shape[0]
    v = mesh.positions.shape[0]
    idx = (mesh.indices[None].astype(np.int64)
           + (np.arange(reps)[:, None, None] * v)).reshape(-1, 3)
    uvs = np.tile(mesh.uvs.astype(np.float64), (reps, 1))
    return Part(pos, nrm, uvs, idx, two_sided, deferred)


def world_parts(world: World) -> Iterator[Part]:
    """The world's objects in the scene build's order (object ``i``'s
    instances drawn with seed ``i``)."""
    for i, desc in enumerate(world.object_descs):
        flags = desc.render_flags
        inst = (desc.generate_instances(seed=i)
                if desc.instance_count > 1 else None)
        yield stage(procedural_mesh(desc.profab_name), inst,
                    two_sided=bool(flags & int(RenderFlags.TWO_SIDED))
                    or "grass" in desc.profab_name,
                    deferred=not bool(flags & int(RenderFlags.FORWARD_SHADING)))
