"""Engine shell: build the demo world, render N frames with the orbit /
time animation, present synchronously.

    python -m zeldaengine_tpu_torch.engine --frames 8 --out frame.png

runs on the card (and raises when there is none); ``--device cpu`` asks
for the plain PyTorch versions on the host. Present is synchronous
(``frames_in_flight=1``, ``present_mode="fifo"``); the livelink server,
the mailbox present queue, resize and the editor protocol of the JAX
package's engine are not ported yet (ROADMAP.md A6).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.passes.frame import render_frame
from zeldaengine_tpu_torch.passes.view import build_view_state
from zeldaengine_tpu_torch.scene.assets import build_scene_from_world
from zeldaengine_tpu_torch.scene.world import World, make_demo_world
from zeldaengine_tpu_torch.utils.device import require_device

LOG = logging.getLogger("zeldaengine.engine")


def _present_u8(color: torch.Tensor) -> torch.Tensor:
    """Quantize a float image to uint8 on device (swapchain format)."""
    return torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)


@dataclasses.dataclass
class FrameStats:
    """The ImGui stats panel, as data."""

    frame_index: int = 0
    # Render + present time of the last frame: CUDA events on the card,
    # the host clock on the CPU.
    frame_ms: float = 0.0
    fps: float = 0.0
    triangles: int = 0


class Engine:
    def __init__(
        self,
        config: Optional[EngineConfig] = None,
        world: Optional[World] = None,
        asset_roots: Optional[List[str]] = None,
        device="cuda",
    ):
        self.device = require_device(device)
        self.config = config or EngineConfig(
            frames_in_flight=1, present_mode="fifo")
        if self.config.frames_in_flight != 1 \
                or self.config.present_mode != "fifo":
            raise NotImplementedError(
                "pipelined / mailbox present is not ported yet "
                "(ROADMAP.md A6: engine.py); use frames_in_flight=1, "
                "present_mode='fifo'")
        self.world = world or make_demo_world()
        self.asset_roots = asset_roots or []
        self.stats = FrameStats()
        self.play_stage_roll = False
        self.play_light_roll = True
        self.roll_stage = 0.0
        self.roll_light = 0.0
        self.time = 0.0
        self.scene, self.meta = build_scene_from_world(
            self.world, self.config, roots=self.asset_roots,
            device=self.device)
        self.stats.triangles = self.meta.num_triangles

    def tick(self, dt: float = 1.0 / 60.0) -> np.ndarray:
        """One DrawFrame: advance the animation by ``dt``, render,
        present. Returns the (H, W, 3) uint8 frame on the host."""
        self.time += dt
        if self.play_stage_roll:
            self.roll_stage += dt * np.radians(15.0)  # :4612
        if self.play_light_roll:
            self.roll_light += dt  # :4603
        view = build_view_state(
            self.world, self.config, time=self.time,
            roll_stage=self.roll_stage, roll_light=self.roll_light,
            device=self.device)
        on_card = self.device.type == "cuda"
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.time()
        color, _aux = render_frame(self.scene, view, self.meta, self.config)
        img = _present_u8(color)
        if on_card:
            end.record()
            host = img.cpu().numpy()  # synchronises
            frame_ms = start.elapsed_time(end)
        else:
            host = img.numpy()
            frame_ms = (time.time() - t0) * 1000.0
        self.stats.frame_index += 1
        self.stats.frame_ms = frame_ms
        self.stats.fps = 1000.0 / max(frame_ms, 1e-6)
        return host

    def run(
        self,
        frames: int,
        on_frame: Optional[Callable[[np.ndarray, FrameStats], None]] = None,
    ) -> None:
        for _ in range(frames):
            img = self.tick()
            if on_frame is not None:
                on_frame(img, self.stats)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="ZeldaEngine on PyTorch + CUDA")
    parser.add_argument("--world", type=str, default=None,
                        help="path to a World.json")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--out", type=str, default=None,
                        help="write the last frame to this PNG")
    parser.add_argument("--assets", type=str, nargs="*", default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu' (plain PyTorch versions)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    config = EngineConfig(width=args.width, height=args.height,
                          frames_in_flight=1, present_mode="fifo")
    world = World(file_path=args.world).load() if args.world else None
    engine = Engine(config=config, world=world, asset_roots=args.assets,
                    device=args.device)
    last = {}

    def on_frame(img, stats):
        last["img"] = img
        LOG.info("frame %d: %.2f ms (%.1f fps), %d tris",
                 stats.frame_index, stats.frame_ms, stats.fps,
                 stats.triangles)

    engine.run(frames=args.frames, on_frame=on_frame)
    if args.out and "img" in last:
        from zeldaengine_tpu_torch.utils import write_png

        write_png(args.out, last["img"])
        LOG.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
