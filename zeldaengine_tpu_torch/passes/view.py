"""Per-frame view state - the analogue of the XkView "scene UBO"
(ZeldaEngine.cpp:922-965) plus the per-frame matrix computation of
UpdateUniformBuffer (:4585-4664).

The matrices and light tables are a few hundred floats: they are computed
on the host (torch CPU ops, fp32) and uploaded once per frame, so the
frame itself launches no tiny per-field kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.math.transforms import (
    look_at,
    perspective_vk,
    rotate_z,
    matmul_f32,
)
from zeldaengine_tpu_torch.scene.world import World, LightDesc
from zeldaengine_tpu_torch.utils.device import require_device


class ViewState(NamedTuple):
    view_proj: torch.Tensor  # (4, 4) cameraProj @ cameraView (Y-flipped)
    shadow_space: torch.Tensor  # (4, 4) shadowProj @ shadowView (Y-flipped)
    model: torch.Tensor  # (4, 4) localToWorld (stage roll, :4614)
    camera_pos: torch.Tensor  # (3,)
    camera_fov: torch.Tensor  # () degrees (cameraInfo.w)
    viewport: torch.Tensor  # (4,) w, h, right_bar, bottom_bar
    dir_lights: torch.Tensor  # (Ld, 4, 4)
    point_lights: torch.Tensor  # (Lp, 4, 4)
    spot_lights: torch.Tensor  # (Ls, 4, 4)
    # (4,) int32: dir, point, spot, cubemap mips. Kept on the HOST: the
    # light loops read the counts as Python ints, and a device copy would
    # cost one synchronising read per frame.
    lights_count: torch.Tensor
    time: torch.Tensor  # ()
    z_near: torch.Tensor  # ()
    z_far: torch.Tensor  # ()
    # () int32 - SPEC_CONSTANTS (push constant); host-side like the counts.
    debug_view: torch.Tensor
    # XkGlobalConstants push-constant overrides (ZeldaEngine.cpp:903-919):
    # basecolor, metallic, specular, roughness multipliers (1.0 = off).
    overrides: torch.Tensor  # (4,)


HOST_LEAVES = ("lights_count", "debug_view")


def _view_matrices(eye, center, light_pos, fov_r, aspect, z_near, z_far,
                   roll_stage):
    """The frame's three matrices (host, fp32)."""
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32)
    cam_view = look_at(eye, center, up)
    cam_proj = perspective_vk(fov_r, aspect, z_near, z_far)
    view_proj = matmul_f32(cam_proj, cam_view)
    shadow_view = look_at(light_pos, torch.zeros(3, dtype=torch.float32), up)
    shadow_proj = perspective_vk(fov_r, 1.0, z_near, z_far)
    shadow_space = matmul_f32(shadow_proj, shadow_view)
    model = rotate_z(np.float32(roll_stage))
    return view_proj, shadow_space, model


def pack_lights(lights: Sequence[LightDesc], capacity: int) -> np.ndarray:
    arr = np.zeros((capacity, 4, 4), np.float32)
    for i, l in enumerate(lights[:capacity]):
        arr[i] = l.packed()
    return arr


def build_view_state(
    world: World,
    config: EngineConfig,
    time: float = 0.0,
    roll_stage: float = 0.0,
    roll_light: float = 0.0,
    debug_view: int = 0,
    animate_point_lights: bool = True,
    light_capacities: Optional[tuple] = None,
    right_bar: float = 0.0,
    bottom_bar: float = 0.0,
    overrides=None,
    device="cuda",
) -> ViewState:
    """Replicates UpdateUniformBuffer (ZeldaEngine.cpp:4585-4664):

    - camera view/proj from the orbit camera (Y-flipped proj)
    - shadow view from directional light 0 toward the origin, shadow proj
      using the *camera's* FOV at aspect 1 (:4614-4616)
    - the point-light ring animation (:4637-4646)

    Every leaf is a fresh tensor on ``device`` (nothing aliases the
    world's arrays), except the two host-side leaves named in
    ``HOST_LEAVES``.
    """
    device = require_device(device)
    cam = world.main_camera
    aspect = config.width / config.height
    fov_r = math.radians(cam.fov)

    if world.directional_lights:
        light_pos = np.array(world.directional_lights[0].position, np.float32)
    else:
        light_pos = np.array([20.0, 0.0, 20.0], np.float32)
    view_proj, shadow_space, model = _view_matrices(
        np.array(cam.position, np.float32),
        np.array(cam.lookat, np.float32),
        light_pos, fov_r, aspect, cam.z_near, cam.z_far,
        np.float32(roll_stage),
    )

    if light_capacities is not None:
        caps = light_capacities
    elif config.adaptive_light_capacity:
        # Pad each table to the next power of two >= its count (min 1);
        # the reference's fixed 16/512/16 capacities
        # (ZeldaEngine.cpp:84-86) remain the upper bounds.
        def cap(n, mx):
            c = 1
            while c < n:
                c *= 2
            return min(c, mx)

        caps = (
            cap(len(world.directional_lights), config.max_directional_lights),
            cap(len(world.point_lights), config.max_point_lights),
            cap(len(world.spot_lights), config.max_spot_lights),
        )
    else:
        caps = (
            config.max_directional_lights,
            config.max_point_lights,
            config.max_spot_lights,
        )
    dir_arr = pack_lights(world.directional_lights, caps[0])
    point_arr = pack_lights(world.point_lights, caps[1])
    spot_arr = pack_lights(world.spot_lights, caps[2])

    n_point = min(len(world.point_lights), caps[1])
    if animate_point_lights and n_point > 0:
        # Spinning ring (:4637-4646)
        i = np.arange(n_point, dtype=np.float32)
        radians = np.radians((i / n_point) * 360.0 - roll_light * 100.0)
        distance = (i / n_point) * 5.0 + 2.5
        point_arr[:n_point, 0, 0] = np.sin(radians) * distance
        point_arr[:n_point, 0, 1] = np.cos(radians) * distance
        point_arr[:n_point, 0, 2] = 1.5

    counts = np.array(
        [
            min(len(world.directional_lights), caps[0]),
            n_point,
            min(len(world.spot_lights), caps[2]),
            config.cubemap_mips,
        ],
        np.int32,
    )

    def up(a, dtype=np.float32):
        # np.array copies: no leaf aliases a host array of the world.
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return ViewState(
        view_proj=view_proj.to(device),
        shadow_space=shadow_space.to(device),
        model=model.to(device),
        camera_pos=up(cam.position),
        camera_fov=up(cam.fov),
        viewport=up([config.width, config.height, right_bar, bottom_bar]),
        dir_lights=up(dir_arr),
        point_lights=up(point_arr),
        spot_lights=up(spot_arr),
        lights_count=torch.from_numpy(counts.copy()),
        time=up(time),
        z_near=up(cam.z_near),
        z_far=up(cam.z_far),
        debug_view=torch.tensor(int(debug_view), dtype=torch.int32),
        overrides=up(np.ones(4, np.float32) if overrides is None
                     else overrides),
    )
