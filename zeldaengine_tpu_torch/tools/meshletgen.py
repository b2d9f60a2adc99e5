"""meshletgen CLI - the ZeldaMeshlet toolkit (ZeldaMeshlet.cpp:123-294).

Bakes an OBJ into a ``.meshlet`` file with the native clusterizer; the file
is byte for byte the one the JAX package's ``tools/meshletgen.py`` writes
from the same OBJ on the same machine:

    python -m zeldaengine_tpu_torch.tools.meshletgen \\
        -i model.obj -o model.meshlet [-v 64] [-t 124]
"""

from __future__ import annotations

import argparse
import sys

from zeldaengine_tpu_torch.meshlet import build_meshlets, save_meshlet_set
from zeldaengine_tpu_torch.scene.mesh import load_obj


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="meshletgen")
    parser.add_argument("-v", "--max-vertices", type=int, default=64)
    parser.add_argument("-t", "--max-triangles", type=int, default=124)
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)

    mesh = load_obj(args.input)
    ms = build_meshlets(
        mesh.positions,
        mesh.indices,
        max_vertices=args.max_vertices,
        max_triangles=args.max_triangles,
        normals=mesh.normals,
        uvs=mesh.uvs,
    )
    save_meshlet_set(args.output, ms)
    tris = sum(m.triangle_count for m in ms.meshlets)
    print(
        f"{args.input}: {mesh.num_vertices} verts, {tris} tris -> "
        f"{len(ms.meshlets)} meshlets -> {args.output}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
