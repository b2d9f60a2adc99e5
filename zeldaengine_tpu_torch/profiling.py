"""Per-pass frame profiling - the tracing subsystem the reference engine
lacks (no timestamp queries or frame timers anywhere in ZeldaEngine.cpp).

``profile_passes`` decomposes one frame into stages in the frame's pass
order (vertex + setup, shadow raster, GBuffer raster, attribute resolve,
PCF, lighting, sky) and times each alone on precomputed device inputs;
``full`` is the whole frame for comparison and ``null`` the cost of one
trivial operation on the device. The stage keys and the conditions under
which each is present are the JAX package's. On the planes route
(``passes/frame.py::raster_route``) the GBuffer raster writes the
winner's attribute planes (kernel ``pair_raster_fused``), so ``attrs`` is
the resolve of those planes into surface attributes; under ``raster``
"pallas" and "jnp", as in the JAX package's profiler, ``raster`` is the
visibility raster (kernel ``pair_raster`` with ids, or brute force) and
``attrs`` the gather path ``surface_attributes``.

On the card each stage is timed with CUDA events around one call after a
warm call, and fenced with ``torch.cuda.synchronize()``; on the CPU the
host clock times it. Each value is the median of ``reps`` calls in ms.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.math.color import gamma_correct
from zeldaengine_tpu_torch.math.transforms import (
    apply_mat4_h, apply_mat4_point)
from zeldaengine_tpu_torch.ops import pbr
from zeldaengine_tpu_torch.ops.lighting import shade_pixels
from zeldaengine_tpu_torch.ops.rasterize import triangle_setup
from zeldaengine_tpu_torch.passes import frame as F
from zeldaengine_tpu_torch.passes.gbuffer import (
    surface_attributes, surface_attributes_from_planes)
from zeldaengine_tpu_torch.scene.scenebuild import GpuScene, SceneMeta


def _time_stage(fn, args, reps: int, on_card: bool) -> float:
    """Median ms of ``reps`` calls of ``fn(*args)`` after a warm call."""
    fn(*args)
    times = []
    for _ in range(reps):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


@torch.no_grad()
def profile_passes(
    scene: GpuScene,
    view,
    meta: SceneMeta,
    config: EngineConfig,
    reps: int = 3,
) -> Dict[str, float]:
    """Returns {stage: median ms}. Stages mirror RecordCommandBuffer's pass
    order (ZeldaEngine.cpp:3160-3744); ``vertex`` covers the vertex
    transforms and the GBuffer's triangle setup shared by the raster
    stages."""
    dev = scene.pair_pos.device
    on_card = dev.type == "cuda"
    height, width = config.height, config.width

    def vertex(scene, view):
        n_p = scene.pair_pos.shape[0]
        world, n1 = apply_mat4_point(view.model, torch.cat(
            [scene.pair_pos, pbr.normalize(scene.pair_nrm)])).split(n_p)
        if scene.rot_table.shape[0] <= 1:
            n_world = n1
        else:
            n_world = F._mat_vec(scene.rot_table[scene.pair_rot.long()], n1)
        clip = apply_mat4_h(view.view_proj, world)
        setup = triangle_setup(
            clip[scene.tri_vtx.long()], width, height,
            two_sided=scene.tri_two_sided,
            valid_mask=scene.tri_valid & scene.tri_deferred,
        )
        return world, n_world, setup

    def shadow(scene, view, world):
        clip_sh = apply_mat4_h(view.shadow_space, world)
        setup_sh = triangle_setup(
            clip_sh[scene.tri_vtx.long()], config.shadowmap_dim,
            config.shadowmap_dim, two_sided=True,
            valid_mask=scene.tri_valid,
            depth_bias=(config.shadow_bias_constant,
                        config.shadow_bias_slope),
        )
        return F._raster_depth(setup_sh, config.shadowmap_dim,
                               config)[0].contiguous()

    f_uv, f_combo, _ = F._fused_flags(meta)
    planes_route = F.raster_route(config) == "planes"

    def raster(scene, setup, world, n_world):
        """(depth, tid, what ``attrs_fn`` resolves: the attribute planes,
        or the visibility buffer's ids)."""
        if not planes_route:
            depth, tid = F._raster_visibility(setup, height, width,
                                              config)[:2]
            return depth, tid, tid
        n_t = setup.edge.shape[0]
        return F._raster_vis_fused(
            setup,
            lambda cidx: F._fused_extra(scene, n_t, world, n_world,
                                        tri_idx=cidx, need_uv=f_uv,
                                        need_combo=f_combo),
            height, width, config, meta=meta)[:3]

    def attrs_fn(scene, resolved):
        if not planes_route:
            return surface_attributes(
                scene, setup, resolved, world, n_world, config,
                var_ch=meta.tex_channels, flat_normal=meta.flat_normal)
        return surface_attributes_from_planes(
            scene, resolved, config, var_ch=meta.tex_channels,
            flat_normal=meta.flat_normal)

    def pcf(shadowmap, attrs, view):
        return F._shadow_factor(shadowmap, attrs.world_pos, view, config,
                                valid=attrs.covered)

    route = F.point_light_route(view, config)

    def lighting(attrs, shadow_factor, view, scene):
        tiled, pallas, _ = F.cull_lights(view, config, route, attrs)
        lit = shade_pixels(
            attrs.base_color, attrs.metallic, attrs.roughness, attrs.normal,
            attrs.ao, attrs.world_pos, shadow_factor, view,
            scene.cube_atlas, config.cubemap_size,
            cube_pair1=scene.cube_pair1, cube_const=scene.cube_const,
            tiled_points=tiled, pallas_points=pallas,
        )
        return gamma_correct(lit["final"] * attrs.mask[..., None])

    def sky(scene, view, depth):
        color = torch.zeros((height, width, 3), dtype=torch.float32,
                            device=dev)
        return F._skydome_analytic(scene, view, depth, color, height, width,
                                   config)

    out: Dict[str, float] = {}
    # The floor of one trivial device operation: subtract mentally from
    # every stage.
    out["null"] = _time_stage(lambda t: t + 1.0,
                              (torch.zeros((), device=dev),), reps, on_card)
    out["vertex"] = _time_stage(vertex, (scene, view), reps, on_card)
    world, n_world, setup = vertex(scene, view)
    if config.enable_shadow:
        out["shadow"] = _time_stage(shadow, (scene, view, world), reps,
                                    on_card)
        shadowmap = shadow(scene, view, world)
    else:
        shadowmap = torch.ones(
            (config.shadowmap_dim, config.shadowmap_dim),
            dtype=torch.float32, device=dev)
    raster_args = (scene, setup, world, n_world)
    out["raster"] = _time_stage(raster, raster_args, reps, on_card)
    depth, _tid, resolved = raster(*raster_args)
    out["attrs"] = _time_stage(attrs_fn, (scene, resolved), reps, on_card)
    attrs = attrs_fn(scene, resolved)
    if config.enable_shadow:
        out["pcf"] = _time_stage(pcf, (shadowmap, attrs, view), reps,
                                 on_card)
        shadow_factor = pcf(shadowmap, attrs, view)
    else:
        shadow_factor = torch.ones(attrs.world_pos.shape[:2],
                                   dtype=torch.float32, device=dev)
    out["lighting"] = _time_stage(
        lighting, (attrs, shadow_factor, view, scene), reps, on_card)
    if meta.enable_skydome and config.enable_skydome:
        out["sky"] = _time_stage(sky, (scene, view, depth), reps, on_card)

    out["full"] = _time_stage(F.render_rows, (scene, view, meta, config),
                              reps, on_card)
    out["sum_of_parts"] = float(
        sum(v for k, v in out.items() if k not in ("full", "sum_of_parts"))
    )
    return out
