"""The JAX demo scene and its deferred pass, shared by
tests/test_torch_fused.py and tests/test_torch_fused_span.py."""

import functools

import jax.numpy as jnp

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.math.transforms import apply_mat4_h, apply_mat4_point
from zeldaengine_tpu.ops import pbr as jpbr
from zeldaengine_tpu.ops.rasterize import triangle_setup as j_triangle_setup
from zeldaengine_tpu.passes.view import build_view_state as j_view
from zeldaengine_tpu.scene.demo import build_demo_scene as j_build

H = W = 128


@functools.lru_cache(maxsize=1)
def fused_state():
    """The JAX demo scene at TEST_CONFIG (20 grass instances a species, 3
    rocks) and its deferred pass at H x W: (config, scene, view, world
    positions, world normals, setup, clip positions). Built once a
    process: both files' module fixtures share it (read only)."""
    cfg = JCFG
    scene, meta, world_desc = j_build(cfg, grass=20, rocks=3)
    view = j_view(world_desc, cfg, time=0.25, roll_light=0.1)
    world = apply_mat4_point(view.model, scene.pair_pos)
    n1 = apply_mat4_point(view.model, jpbr.normalize(scene.pair_nrm))
    n_world = jnp.einsum("pij,pj->pi", scene.rot_table[scene.pair_rot], n1,
                         precision="highest")
    clip = apply_mat4_h(view.view_proj, world)
    setup = j_triangle_setup(
        clip[scene.tri_vtx], W, H, two_sided=scene.tri_two_sided,
        valid_mask=scene.tri_valid & scene.tri_deferred)
    return cfg, scene, view, world, n_world, setup, clip
