"""Demo scene assembly - the CreateEngineWorld procedural world
(ZeldaEngine.cpp:4043-4137) at configurable instance scale."""

from __future__ import annotations

import os
from typing import List, Optional

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.scene.assets import build_scene_from_world
from zeldaengine_tpu_torch.scene.world import World, make_demo_world

# Optional checkout of the reference engine's Content/ tree.
CONTENT_ROOT_ENV = "ZELDA_CONTENT_ROOT"


def demo_world(grass: int = 10000, rocks: int = 64) -> World:
    """The reference demo world, instance counts scaled."""
    w = make_demo_world()
    w.object_descs[2].instance_count = rocks
    w.object_descs[3].instance_count = grass
    w.object_descs[4].instance_count = grass
    return w


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
        roots = []
        content = os.environ.get(CONTENT_ROOT_ENV, "")
        if content and os.path.isdir(content):
            roots.append(content)
    world = demo_world(grass=grass, rocks=rocks)
    scene, meta = build_scene_from_world(world, config, roots=roots,
                                         device=device)
    return scene, meta, world
