"""The one traffic generator: a traffic file's parameters and a seed in,
the camera of every frame and the pushes of the livelink out.

A traffic file (``frame_bench/traffic/<name>.json``) holds:

- ``camera.yaw_step_deg``: the orbit step each frame takes through the
  engine's own input (``Engine.orbit``) or, for a ``render_frame`` entry,
  the harness's camera; 0 keeps the camera still between pushes.
- ``camera.start_yaw_deg``: [lo, hi), the range the seed draws the first
  orbit step from (the traffic's starting phase).
- ``pushes``: null, or ``interval_s`` (a world pushed over the livelink
  every so many seconds, from a thread of the benchmark) and
  ``yaw_step_deg`` (each push's camera is the last one's orbited by it).

The seed sets only the starting phase and which frames the check samples:
never the scene, its scale or the step sizes.
"""

from __future__ import annotations

import numpy as np


class Traffic:
    def __init__(self, params: dict, seed: int):
        if int(seed) < 0:
            raise ValueError(f"--seed must be >= 0, got {seed}")
        self.params = params
        self.seed = int(seed)
        cam = params["camera"]
        lo, hi = cam["start_yaw_deg"]
        rng = np.random.default_rng([self.seed, 0])
        self.start_yaw = float(rng.uniform(lo, hi))
        self.yaw_step = float(cam["yaw_step_deg"])
        pushes = params.get("pushes")
        self.push_interval = float(pushes["interval_s"]) if pushes else None
        self.push_yaw_step = float(pushes["yaw_step_deg"]) if pushes else 0.0

    def sample_points(self, k: int) -> list:
        """``k`` sorted fractions of the window at which the check keeps the
        frame then rendered (its own stream of the seed)."""
        rng = np.random.default_rng([self.seed, 1])
        return sorted(float(x) for x in rng.uniform(0.05, 0.95, k))

    def frame_yaws(self):
        """The orbit steps before frame 0 and before every later frame:
        (first, each)."""
        return self.start_yaw, self.yaw_step

    def push_cameras(self, camera, n: int) -> np.ndarray:
        """(n, 3) float32 positions of the first ``n`` pushes' cameras:
        ``camera`` (a ``CameraDesc`` of the reference copy) orbited by the
        start angle, then by the push step each push."""
        camera.add_movement(self.start_yaw, 0.0)
        out = np.empty((n, 3), np.float32)
        for i in range(n):
            if i:
                camera.add_movement(self.push_yaw_step, 0.0)
            out[i] = camera.position
        return out
