"""Meshes shared by the meshlet tests of the port
(tests/test_torch_meshlet*.py): seeded triangle soups, spheres, the
OBJ grids, and a meshlet set's arrays."""

import numpy as np

from zeldaengine_tpu_torch.meshlet import build_meshlets
from zeldaengine_tpu_torch.scene import make_sphere


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
