"""Demo scene assembly - the CreateEngineWorld procedural world
(ZeldaEngine.cpp:4043-4137) at configurable instance scale."""

from __future__ import annotations

import os
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.scene.assets import build_scene_from_world
from zeldaengine_tpu_torch.scene.world import World, make_demo_world
from zeldaengine_tpu_torch.utils.device import require_device

# Optional checkout of the reference engine's Content/ tree.
CONTENT_ROOT_ENV = "ZELDA_CONTENT_ROOT"
# Generated Profabs of the textured demo (git-ignored).
CACHE_ROOT = Path(__file__).resolve().parent.parent / "_cache"


def demo_world(grass: int = 10000, rocks: int = 64) -> World:
    """The reference demo world, instance counts scaled."""
    w = make_demo_world()
    w.object_descs[2].instance_count = rocks
    w.object_descs[3].instance_count = grass
    w.object_descs[4].instance_count = grass
    return w


def _content_roots() -> List[str]:
    content = os.environ.get(CONTENT_ROOT_ENV, "")
    return [content] if content and os.path.isdir(content) else []


def build_demo_scene(
    config: EngineConfig,
    grass: int = 1000,
    rocks: int = 64,
    roots: Optional[List[str]] = None,
    device="cuda",
):
    """Returns (GpuScene, SceneMeta, World) with the pools on ``device``.
    Uses the reference engine's Content assets when the environment
    variable ``ZELDA_CONTENT_ROOT`` names a checkout of them, procedural
    stand-ins otherwise."""
    if roots is None:
        roots = _content_roots()
    world = demo_world(grass=grass, rocks=rocks)
    scene, meta = build_scene_from_world(world, config, roots=roots,
                                         device=device)
    return scene, meta, world


def write_textured_profabs(cache_dir: str, size: int) -> None:
    """Write the textured demo's Profab root once (``COMPLETE`` marks it):
    the procedural meshes as OBJs plus noise/checker textures for every
    PBR slot (7-slot sampling, Base.frag:24-30). The JAX package seeds
    each Profab's noise with ``hash(name)``, which changes per process;
    here the seed is ``zlib.crc32(name)``, the same in every run."""
    from zeldaengine_tpu_torch.scene.assets import _procedural_profab
    from zeldaengine_tpu_torch.scene.mesh import save_obj
    from zeldaengine_tpu_torch.utils.image import write_png

    stamp = os.path.join(cache_dir, "COMPLETE")
    if os.path.exists(stamp):
        return
    for name in ("terrain", "rock_01", "rock_02", "grass_01", "grass_02"):
        pdir = os.path.join(cache_dir, "Profabs", name)
        os.makedirs(os.path.join(pdir, "models"), exist_ok=True)
        os.makedirs(os.path.join(pdir, "textures"), exist_ok=True)
        save_obj(_procedural_profab(name),
                 os.path.join(pdir, "models", name + ".obj"))
        rng = np.random.RandomState(zlib.crc32(name.encode()) % (2**31))
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        checker = ((xx * 8).astype(int) + (yy * 8).astype(int)) % 2

        def smooth_noise(lo, hi):
            n = rng.rand(size // 8, size // 8).astype(np.float32)
            n = np.kron(n, np.ones((8, 8), np.float32))
            return lo + (hi - lo) * n

        slots = {
            "_bc": np.stack([0.25 + 0.55 * checker,
                             smooth_noise(0.2, 0.9),
                             smooth_noise(0.1, 0.6)], -1),
            "_m": np.repeat(smooth_noise(0.0, 0.8)[..., None], 3, -1),
            "_r": np.repeat(smooth_noise(0.25, 1.0)[..., None], 3, -1),
            "_n": np.stack([0.5 + 0.25 * (smooth_noise(-1, 1)),
                            0.5 + 0.25 * (smooth_noise(-1, 1)),
                            np.full((size, size), 0.9, np.float32)], -1),
            "_ao": np.repeat(smooth_noise(0.6, 1.0)[..., None], 3, -1),
            "_ev": np.zeros((size, size, 3), np.float32),
            "_ms": np.ones((size, size, 3), np.float32),
        }
        for suffix, img in slots.items():
            write_png(os.path.join(pdir, "textures", name + suffix + ".png"),
                      np.clip(img, 0.0, 1.0))
    with open(stamp, "w") as f:
        f.write("ok\n")


def build_textured_demo_scene(
    config: EngineConfig,
    grass: int = 1000,
    rocks: int = 64,
    roots: Optional[List[str]] = None,
    cache_dir: Optional[str] = None,
    device="cuda",
):
    """The demo scene with per-slot PBR textures (bench config 3t): the
    same meshes and instancing as ``build_demo_scene``, loaded from a
    generated Profab root (``write_textured_profabs``; by default under the
    package's git-ignored ``_cache/``), so the varying material channels
    go through the mip-pair atlas fetch and the roughness texture spans
    [0.25, 1] (the variable-lod cube reflection is taken). Returns
    (GpuScene, SceneMeta, World)."""
    require_device(device)
    size = config.texture_size
    cache_dir = cache_dir or str(CACHE_ROOT / f"profabs3t_{size}")
    write_textured_profabs(cache_dir, size)
    all_roots = [cache_dir] + (roots if roots else _content_roots())
    world = demo_world(grass=grass, rocks=rocks)
    scene, meta = build_scene_from_world(world, config, roots=all_roots,
                                         device=device)
    assert meta.tex_channels, "3t build must exercise the texture path"
    return scene, meta, world


def build_golden_scene(config: EngineConfig, right_bar: float = 0.0,
                       bottom_bar: float = 0.0, device="cuda"):
    """The regression scene of the committed goldens
    (tests/test_golden.py::_build, tests/golden/*.png): a deferred floor, a
    checker-textured deferred cube, a forward sphere (inside the cube), a
    flat blue cubemap and a vertical sky gradient, one moon and one point
    light. ``right_bar`` / ``bottom_bar`` reserve the editor's bars (view
    9). Returns (GpuScene, SceneMeta, ViewState) with debug view 0."""
    from zeldaengine_tpu_torch.passes.view import build_view_state
    from zeldaengine_tpu_torch.scene.mesh import (
        make_cube, make_plane, make_sphere)
    from zeldaengine_tpu_torch.scene.scenebuild import SceneBuilder
    from zeldaengine_tpu_torch.scene.world import CameraDesc, LightDesc

    b = SceneBuilder(config)
    c = (np.indices((config.texture_size,) * 2).sum(0) // 8 % 2).astype(
        np.float32)
    checker = np.stack(
        [0.15 + 0.55 * c, 0.25 + 0.2 * c, 0.7 - 0.45 * c, np.ones_like(c)],
        -1)
    b.add_object(make_plane(4.0), b.add_material({}), deferred=True)
    b.add_object(make_cube(1.0, center=(0, 0, 0.5)),
                 b.add_material({0: checker}), deferred=True)
    b.add_object(make_sphere(0.35, rings=12, sectors=18), b.add_material({}),
                 deferred=False)
    faces = np.zeros((6, config.cubemap_size, config.cubemap_size, 4),
                     np.float32)
    faces[..., 2] = 0.3
    faces[..., 1] = 0.15
    faces[..., 3] = 1.0
    b.set_cubemap(faces)
    ss = config.background_size
    g = np.linspace(1, 0, ss, dtype=np.float32)[:, None] * np.ones(
        (1, ss), np.float32)
    b.set_skydome_texture(np.stack([0.2 * g, 0.4 * g, 0.8 * g,
                                    np.ones_like(g)], -1))
    scene, meta = b.build(device)

    w = World()
    w.main_camera = CameraDesc(
        position=np.array([3.0, -3.0, 2.2], np.float32),
        lookat=np.array([0.0, 0.0, 0.4], np.float32))
    moon = np.array([15.0, -5.0, 20.0], np.float32)
    w.directional_lights = [
        LightDesc(position=moon, type=0,
                  color=np.array([1.0, 0.9, 0.75], np.float32),
                  intensity=3.5, direction=moon / np.linalg.norm(moon))]
    w.point_lights = [
        LightDesc(position=np.array([-1.0, -1.0, 1.2], np.float32), type=1,
                  color=np.array([0.9, 0.3, 0.1], np.float32), intensity=6.0,
                  radius=4.0)]
    view = build_view_state(w, config, light_capacities=(2, 2, 2),
                            animate_point_lights=False, device=device,
                            right_bar=right_bar, bottom_bar=bottom_bar)
    return scene, meta, view
