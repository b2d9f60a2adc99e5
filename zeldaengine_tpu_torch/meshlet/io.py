"""Binary .meshlet serde - byte-compatible with MeshletSet::save/load
(ZeldaMeshlet.cpp:51-122): five length-prefixed (size_t) arrays of
Meshlet (64 B), uint32, uint8, Vertex (32 B: pos3+normal3+uv2 float32),
uint32, so caches baked by either tool (and by the JAX package) interoperate.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from zeldaengine_tpu_torch.meshlet.build import MeshletSet, meshlet_from_record
from zeldaengine_tpu_torch.native import MESHLET_REC


def _write_size(f: BinaryIO, n: int) -> None:
    f.write(struct.pack("<Q", n))


def _read_array(f: BinaryIO, dtype, item_bytes: int) -> np.ndarray:
    n = struct.unpack("<Q", f.read(8))[0]
    raw = f.read(n * item_bytes)
    if len(raw) != n * item_bytes:
        raise ValueError(f"truncated .meshlet file: {len(raw)} of "
                         f"{n * item_bytes} bytes")
    return np.frombuffer(raw, dtype).copy()


def save_meshlet_set(path: str, ms: MeshletSet) -> None:
    recs = np.zeros(len(ms.meshlets), MESHLET_REC)
    for i, m in enumerate(ms.meshlets):
        recs[i]["vertex_offset"] = m.vertex_offset
        recs[i]["vertex_count"] = m.vertex_count
        recs[i]["triangle_offset"] = m.triangle_offset
        recs[i]["triangle_count"] = m.triangle_count
        recs[i]["bounds_center"] = m.bounds_center
        recs[i]["bounds_radius"] = m.bounds_radius
        recs[i]["cone_apex"] = m.cone_apex
        recs[i]["cone_axis"] = m.cone_axis
        recs[i]["cone_cutoff"] = m.cone_cutoff
    with open(path, "wb") as f:
        for arr in (
            recs,
            np.ascontiguousarray(ms.meshlet_vertices, "<u4"),
            np.ascontiguousarray(ms.meshlet_triangles, "u1"),
            np.ascontiguousarray(ms.vertices, "<f4"),
            np.ascontiguousarray(ms.indices, "<u4"),
        ):
            _write_size(f, arr.shape[0])
            f.write(arr.tobytes())


def load_meshlet_set(path: str) -> MeshletSet:
    with open(path, "rb") as f:
        recs = _read_array(f, MESHLET_REC, 64)
        mv = _read_array(f, "<u4", 4)
        mt = _read_array(f, "u1", 1)
        verts = _read_array(f, "<f4", 32).reshape(-1, 8)
        idx = _read_array(f, "<u4", 4)
    return MeshletSet(
        meshlets=[meshlet_from_record(r) for r in recs],
        meshlet_vertices=mv,
        meshlet_triangles=mt,
        vertices=verts,
        indices=idx,
    )
