"""The bench configurations and scenes that the port's scripts share
(``chip_smoke.py``, ``tools/walk_stats.py``): the counterpart of the JAX
package's root ``tools/_scenes.py``, so that no script keeps its own copy.
"""

from __future__ import annotations

import time

import numpy as np

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.meshlet import build_meshlets
from zeldaengine_tpu_torch.scene import (
    CameraDesc, LightDesc, SceneBuilder, World, make_sphere)


def config3() -> EngineConfig:
    """bench.py's config 3 (bench.py:442-448), nothing else changed."""
    return EngineConfig(width=1920, height=1080, tile_h=64, tile_w=32,
                        max_pairs=384 * 1024, max_pairs_shadow=256 * 1024)


def config4() -> EngineConfig:
    """bench.py's config 4 (bench.py:254-334), nothing changed."""
    return EngineConfig(width=1024, height=1024, shadowmap_dim=512,
                        texture_size=128, cubemap_size=64,
                        background_size=128, max_point_lights=8,
                        pair_expand=4, pair_expand_shadow=2,
                        compact_tris=384 * 1024,
                        compact_tris_shadow=96 * 1024,
                        shadow_cone_cull=True, subpixel_cull=True,
                        max_pairs=384 * 1024, max_pairs_shadow=64 * 1024)


def config4_scene(config, device="cuda"):
    """Config 4's scene as bench.py builds it: 16 spheres of
    make_sphere(0.8, 140, 230) on a 4x4 grid, each baked to meshlets by the
    native builder, and bench.py's make_world(pos=(6, -6, 3), lookat=(0, 0,
    0.8), z_far=80). Returns (scene, meta, world, bake seconds)."""
    b = SceneBuilder(config)
    mat = b.add_material({})
    t0 = time.time()
    mesh = make_sphere(0.8, rings=140, sectors=230)
    for i in range(16):
        offs = np.float32([(i % 4 - 1.5) * 2.2, (i // 4 - 1.5) * 2.2, 0.8])
        b.add_meshlet_object(build_meshlets(
            mesh.positions + offs, mesh.indices, normals=mesh.normals,
            uvs=mesh.uvs), mat)
    bake_s = time.time() - t0
    scene, meta = b.build(device)
    w = World()
    w.main_camera = CameraDesc(position=np.float32([6.0, -6.0, 3.0]),
                               lookat=np.float32([0.0, 0.0, 0.8]),
                               z_far=80.0)
    moon = np.float32([20.0, 0.0, 20.0])
    w.directional_lights = [
        LightDesc(position=moon, type=0,
                  color=np.float32([1.0, 0.95, 0.85]), intensity=3.0,
                  direction=moon / np.linalg.norm(moon))]
    return scene, meta, w, bake_s
