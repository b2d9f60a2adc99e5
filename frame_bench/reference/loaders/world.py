"""World model, read from its JSON document (frozen from
``zeldaengine_tpu_torch/scene/world.py`` at commit fcd25b5, its writers
left out).

Wire/file-compatible with the reference's ``XkWorld`` JSON schema
(ZeldaEngine.cpp:1051-1147 Load, :1149-1263 Save) and the livelink client
(ZeldaPython/ZeldaUntitled.py:54-86): top-level keys MainCamera, Skydome,
Background, DirectionalLights, PointLights, SpotLights, Objects.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
from typing import List, Optional

import numpy as np


class RenderFlags(enum.IntFlag):
    """EXkRenderFlags (ZeldaEngine.cpp:352-366)."""

    NONE = 1 << 0  # vertex-only, deferred shading path
    VERTEX_INDEXED = 1 << 1
    INSTANCED = 1 << 2
    SCREEN_RECT = 1 << 3
    TWO_SIDED = 1 << 4
    NO_DEPTH_TEST = 1 << 5
    SHADOW = 1 << 6
    SKYDOME = 1 << 7
    BACKGROUND = 1 << 8
    FORWARD_SHADING = 1 << 9
    DEFERRED_SCENE = 1 << 10
    DEFERRED_LIGHTING = 1 << 11


@dataclasses.dataclass
class CameraDesc:
    """XkCameraDesc (ZeldaEngine.cpp:619-669): orbit camera with Z-up."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([5.0, 5.0, 5.0], np.float32)
    )
    lookat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 0.5], np.float32)
    )
    speed: float = 2.5
    fov: float = 45.0  # degrees
    z_near: float = 0.1
    z_far: float = 45.0

    @property
    def arm_length(self) -> float:
        return float(np.linalg.norm(self.position - self.lookat))

    @property
    def direction(self) -> np.ndarray:
        d = self.lookat - self.position
        return d / np.linalg.norm(d)

    @property
    def yaw(self) -> float:
        d = self.direction
        return math.degrees(math.atan2(d[0], d[1]))

    @property
    def pitch(self) -> float:
        return math.degrees(math.asin(float(np.clip(self.direction[2], -1, 1))))

    def add_movement(self, delta_yaw: float, delta_pitch: float) -> None:
        """XkCameraDesc::AddMovement (:643-657): orbit about lookat."""
        yaw = self.yaw + delta_yaw
        pitch = max(-89.9, min(89.9, self.pitch + delta_pitch))
        yr, pr = math.radians(yaw), math.radians(pitch)
        # NOTE: replicates the reference's exact (quirky) direction formula,
        # including cos(yaw)*cos(pitch) on Y.
        direction = np.array(
            [
                math.cos(pr) * math.sin(yr),
                math.cos(yr) * math.cos(pr),
                math.sin(pr),
            ],
            np.float32,
        )
        self.position = self.lookat - direction * self.arm_length


@dataclasses.dataclass
class LightDesc:
    """XkLightDesc (ZeldaEngine.cpp:607-617)."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    type: int = 0  # 0 directional, 1 point, 2 spot
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    intensity: float = 1.0
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0], np.float32)
    )
    radius: float = 0.0
    extra_data: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float32)
    )


@dataclasses.dataclass
class ObjectDesc:
    """XkObjectDesc (ZeldaEngine.cpp:554-605): a prefab reference plus
    procedural ring-scatter instance generation parameters."""

    profab_name: str = ""
    render_flags: int = int(RenderFlags.NONE)
    instance_count: int = 0
    min_radius: float = 0.0
    max_radius: float = 0.0
    min_pscale: float = 0.0
    max_pscale: float = 0.0
    min_rot_yaw: float = 0.0
    max_rot_yaw: float = 0.0
    min_rot_roll: float = 0.0
    max_rot_roll: float = 0.0
    min_rot_pitch: float = 0.0
    max_rot_pitch: float = 0.0

    def generate_instances(self, seed: int = 0) -> np.ndarray:
        """XkObjectDesc::GenerateInstance (ZeldaEngine.cpp:573-590).

        Ring scatter in the XY plane: random angle in [0,360), random radius
        in [min_radius, max_radius], Z=0; yaw = pi * U(0,180) (the
        reference's literal formula), uniform scale, random texIndex 0-255.

        Returns (N, 8) float32: pos(3), rot(3), pscale, tex_index.
        """
        n = int(self.instance_count)
        rng = np.random.RandomState(seed)
        out = np.zeros((n, 8), np.float32)
        if n == 0:
            return out
        radians = np.radians(rng.uniform(0.0, 360.0, n))
        distance = rng.uniform(self.min_radius, self.max_radius, n)
        out[:, 0] = np.sin(radians) * distance
        out[:, 1] = np.cos(radians) * distance
        out[:, 2] = 0.0
        out[:, 4] = math.pi * rng.uniform(0.0, 180.0, n)  # rotation.y (yaw)
        out[:, 6] = rng.uniform(self.min_pscale, self.max_pscale, n)
        out[:, 7] = rng.randint(0, 256, n).astype(np.float32)
        return out


def _vec(x, n=3):
    return np.asarray([float(v) for v in x][:n], np.float32)


@dataclasses.dataclass
class World:
    """XkWorld (ZeldaEngine.cpp:1025-1291)."""

    file_path: str = "Content/World.json"

    enable_skydome: bool = True
    override_skydome: bool = True
    skydome_file_name: str = "Content/Textures/skydome.png"

    override_cubemap: bool = True
    cubemap_file_names: List[str] = dataclasses.field(
        default_factory=lambda: [
            "Content/Textures/cubemap_X0.png",
            "Content/Textures/cubemap_X1.png",
            "Content/Textures/cubemap_Y2.png",
            "Content/Textures/cubemap_Y3.png",
            "Content/Textures/cubemap_Z4.png",
            "Content/Textures/cubemap_Z5.png",
        ]
    )

    enable_background: bool = True
    override_background: bool = True
    background_file_name: str = "Content/Textures/background.png"

    main_camera: CameraDesc = dataclasses.field(default_factory=CameraDesc)

    directional_lights: List[LightDesc] = dataclasses.field(default_factory=list)
    point_lights: List[LightDesc] = dataclasses.field(default_factory=list)
    spot_lights: List[LightDesc] = dataclasses.field(default_factory=list)

    object_descs: List[ObjectDesc] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------ serde

    @staticmethod
    def _light_from_json(j: dict) -> LightDesc:
        d = LightDesc()
        return LightDesc(
            position=_vec(j.get("Position", d.position)),
            type=int(j.get("Type", d.type)),
            color=_vec(j.get("Color", d.color)),
            intensity=float(j.get("Intensity", d.intensity)),
            direction=_vec(j.get("Direction", d.direction)),
            radius=float(j.get("Radius", d.radius)),
            extra_data=_vec(j.get("ExtraData", d.extra_data), 4),
        )

    def load(self, raw_data: Optional[str] = None) -> "World":
        """XkWorld::Load (:1051): reset then parse from file or raw string.

        Degrades gracefully per key (like rapidjson's HasMember guards in
        the reference): missing sections/fields keep their Reset defaults
        instead of rejecting the whole world."""
        self.reset()
        if raw_data is None:
            with open(self.file_path, "r") as f:
                doc = json.load(f)
        else:
            doc = json.loads(raw_data)

        cam = doc.get("MainCamera", {})
        d = CameraDesc()
        self.main_camera = CameraDesc(
            position=_vec(cam.get("Position", d.position)),
            lookat=_vec(cam.get("Lookat", d.lookat)),
            speed=float(cam.get("Speed", d.speed)),
            fov=float(cam.get("FOV", d.fov)),
            z_near=float(cam.get("zNear", d.z_near)),
            z_far=float(cam.get("zFar", d.z_far)),
        )

        sky = doc.get("Skydome", {})
        self.enable_skydome = bool(sky.get("EnableSkydome",
                                           self.enable_skydome))
        self.override_skydome = bool(sky.get("OverrideSkydome",
                                             self.override_skydome))
        self.skydome_file_name = sky.get("SkydomeFileName",
                                         self.skydome_file_name)
        self.override_cubemap = bool(sky.get("OverrideCubemap",
                                             self.override_cubemap))
        names = list(sky.get("CubemapFileNames", []))
        for i, name in enumerate(names[:6]):
            self.cubemap_file_names[i] = name

        bg = doc.get("Background", {})
        self.enable_background = bool(bg.get("EnableBackground",
                                             self.enable_background))
        self.override_background = bool(bg.get("OverrideBackground",
                                               self.override_background))
        self.background_file_name = bg.get("BackgroundFileName",
                                           self.background_file_name)

        self.directional_lights = [
            self._light_from_json(j) for j in doc.get("DirectionalLights", [])
        ]
        self.point_lights = [
            self._light_from_json(j) for j in doc.get("PointLights", [])
        ]
        self.spot_lights = [
            self._light_from_json(j) for j in doc.get("SpotLights", [])
        ]

        for j in doc.get("Objects", []):
            self.object_descs.append(
                ObjectDesc(
                    profab_name=j.get("ProfabName", ""),
                    render_flags=int(j.get("RenderFlags",
                                           int(RenderFlags.NONE))),
                    instance_count=int(j.get("InstanceCount", 0)),
                    min_radius=float(j.get("MinRadius", 0.0)),
                    max_radius=float(j.get("MaxRadius", 0.0)),
                    min_rot_yaw=float(j.get("MinRotYaw", 0.0)),
                    max_rot_yaw=float(j.get("MaxRotYaw", 0.0)),
                    min_rot_roll=float(j.get("MinRotRoll", 0.0)),
                    max_rot_roll=float(j.get("MaxRotRoll", 0.0)),
                    min_rot_pitch=float(j.get("MinRotPitch", 0.0)),
                    max_rot_pitch=float(j.get("MaxRotPitch", 0.0)),
                    min_pscale=float(j.get("MinPScale", 0.0)),
                    max_pscale=float(j.get("MaxPScale", 0.0)),
                )
            )
        return self

    def reset(self) -> None:
        """XkWorld::Reset (:1265-1290): defaults, clear lights/objects."""
        self.enable_skydome = True
        self.override_skydome = True
        self.skydome_file_name = "Content/Textures/skydome.png"
        self.override_cubemap = True
        self.cubemap_file_names = [
            "Content/Textures/cubemap_X0.png",
            "Content/Textures/cubemap_X1.png",
            "Content/Textures/cubemap_Y2.png",
            "Content/Textures/cubemap_Y3.png",
            "Content/Textures/cubemap_Z4.png",
            "Content/Textures/cubemap_Z5.png",
        ]
        self.enable_background = True
        self.override_background = True
        self.background_file_name = "Content/Textures/background.png"
        self.directional_lights = []
        self.point_lights = []
        self.spot_lights = []
        self.object_descs = []

