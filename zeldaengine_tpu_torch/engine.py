"""The engine shell: interactive render loop with livelink hot reload.

    python -m zeldaengine_tpu_torch.engine --frames 8 --out frame.png

runs on the card (and raises when there is none); ``--device cpu`` asks
for the plain PyTorch versions on the host.

Replaces XkZeldaEngineApp's Run/MainTick/DrawFrame (ZeldaEngine.cpp:1576,
:1743, :1940) minus the OS window: frames are rendered offscreen and can be
written to PNG or handed to a callback. A world pushed over the TCP
livelink (``livelink/``, the wire format of ZeldaPython/ZeldaUntitled.py)
is loaded on the next tick; it rebuilds the scene pools only when the
content the build reads changed (objects, assets), not for camera or light
values.

The global-input surface (XkGlobalInput, :860-900) maps to methods:
orbit(), zoom(), focus(), set_debug_view (keys 0-9), toggles for stage/light
roll (M / L keys) and game mode, resize, set_wireframe.

Present (``EngineConfig.frames_in_flight`` / ``present_mode``): the frame
is quantised to uint8 on the device; with one frame in flight ``tick``
copies it to the host and returns it. With more, the copy to pinned host
memory is queued on the stream behind the frame, and a fetch thread waits
for it:

- ``fifo``: the queue holds ``frames_in_flight`` frames (``put`` blocks
  at that depth) and tick n returns frame n - frames_in_flight + 1, or
  the first frame since the last drain (start, resize, wireframe toggle,
  scene rebuild) when that is later: an edit presents one tick later at
  two frames in flight.
- ``mailbox``: a full queue drops its stalest pending frame (counted in
  ``FrameStats.presents_dropped``) and tick never blocks; it returns the
  newest fetched frame, waiting only for the first frame since a drain.

A failed fetch is raised by the next tick; nothing falls back.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.livelink.server import LivelinkServer
from zeldaengine_tpu_torch.passes.frame import render_frame
from zeldaengine_tpu_torch.passes.view import build_view_state
from zeldaengine_tpu_torch.scene.assets import (
    build_scene_from_world, scene_asset_fingerprint)
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
    # Host time of the last tick's render plus present, as in the JAX
    # package. Under mailbox present (and on the card generally) that is
    # the time to dispatch the frame, not its device time: time N ticks
    # followed by a device synchronise for a rate.
    frame_ms: float = 0.0
    fps: float = 0.0
    triangles: int = 0
    reloads: int = 0
    # MAILBOX present mode: rendered frames whose host fetch was
    # superseded by a newer frame before the fetch thread got to them
    # (the swapchain's discarded mailbox images). Frames that a drain
    # (resize, wireframe toggle, scene rebuild) throws away are not
    # counted: rendered = fetched + presents_dropped holds between drains.
    presents_dropped: int = 0
    # Per-pass ms breakdown; filled by Engine.profile_passes().
    pass_ms: dict = dataclasses.field(default_factory=dict)
    # Validation counters (EngineConfig.validation=True): nonfinite
    # pixels, tile light-cull drops, pair overflow, oversized
    # (global-bucket) triangles.
    validation: dict = dataclasses.field(default_factory=dict)


class Engine:
    def __init__(
        self,
        config: Optional[EngineConfig] = None,
        world: Optional[World] = None,
        asset_roots: Optional[List[str]] = None,
        livelink_port: Optional[int] = 8080,
        device="cuda",
    ):
        self.device = require_device(device)
        self.config = config or EngineConfig()
        if self.config.present_mode not in ("fifo", "mailbox"):
            raise ValueError(
                f"present_mode={self.config.present_mode!r}: expected "
                "'fifo' or 'mailbox'")
        self.world = world or make_demo_world()
        self.asset_roots = asset_roots or []
        self.scene = None
        self.meta = None
        self.stats = FrameStats()

        # GlobalInput state (ZeldaEngine.cpp:860-900)
        self.debug_view = 0
        # XkGlobalConstants material overrides (:903-919): basecolor,
        # metallic, specular, roughness multipliers.
        self.material_overrides = np.ones(4, np.float32)
        self.play_stage_roll = False
        self.play_light_roll = False
        self.roll_stage = 0.0
        self.roll_light = 0.0
        # 'G' game mode hides the editor bars (RightBarSpace/BottomBarSpace,
        # :4343-4344 - the ImGui outliner/details reserve 20% right+bottom).
        self.game_mode = True
        self.editor_right_frac = 0.2
        self.editor_bottom_frac = 0.2
        self._start_time = time.time()
        self._last_time = self._start_time

        # Guards world/engine state against editor-protocol commands from
        # the socket thread.
        self.lock = threading.RLock()
        self._needs_rebuild = False
        # Pipelined present (frames_in_flight > 1): the queue of pending
        # frames, the thread that fetches them, the fetched frames by
        # sequence number, the first sequence number since the last drain
        # and the count of drains; all guarded by _present_cond.
        self._present_q: Optional[queue.Queue] = None
        self._fetch_thread: Optional[threading.Thread] = None
        self._present_cond = threading.Condition()
        self._fetched = {}
        self._fetch_error: Optional[BaseException] = None
        self._seq = 0
        self._drain_seq = 1
        self._drains = 0

        self.server: Optional[LivelinkServer] = None
        if livelink_port is not None:
            from zeldaengine_tpu_torch.livelink.editor import EditorHandler

            self.server = LivelinkServer(
                port=livelink_port,
                on_command=EditorHandler(self).handle,
            )

        self._rebuild_scene()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self.server is not None:
            self.server.start()

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
        if self._present_q is not None:
            self._drain_present()
            self._present_q.put(None)  # ends the fetch thread
            self._fetch_thread.join(timeout=10.0)
            self._present_q = None
            self._fetch_thread = None

    def _scene_content_key(self) -> str:
        """World content that affects the built scene: everything except
        the camera (which only feeds the per-frame ViewState) and light
        VALUES (also per-frame) - plus the mtimes of every on-disk asset
        the build would read, so editing a texture/OBJ and re-pushing an
        identical world still refreshes the scene."""
        doc = self.world.to_json()
        doc.pop("MainCamera", None)
        doc.pop("DirectionalLights", None)
        doc.pop("PointLights", None)
        doc.pop("SpotLights", None)
        assets = scene_asset_fingerprint(self.world, self.asset_roots)
        return json.dumps(doc, sort_keys=True) + "|" + assets

    def _rebuild_scene(self, force: bool = False) -> None:
        # Streamed reloads that only move the camera/lights keep the same
        # geometry/texture pools: skip the rebuild (the reference always
        # pays the full CreateEngineScene here, ZeldaEngine.cpp:1943-1951).
        key = self._scene_content_key()
        if not force and self.scene is not None \
                and key == getattr(self, "_scene_key", None):
            return
        self._scene_key = key
        self._drain_present()
        t0 = time.time()
        self.scene, self.meta = build_scene_from_world(
            self.world, self.config, roots=self.asset_roots,
            device=self.device)
        self.stats.triangles = self.meta.num_triangles
        LOG.info(
            "scene built: %d tris, %d pairs (%.2fs)",
            self.meta.num_triangles,
            self.meta.num_pairs,
            time.time() - t0,
        )

    # ----------------------------------------------------------------- input

    def set_debug_view(self, index: int) -> None:
        """Keys 0-9 (KeyboardCallback, ZeldaEngine.cpp:1803-1842)."""
        self.debug_view = int(np.clip(index, 0, 9))

    def request_rebuild(self) -> None:
        """Flag the scene for a rebuild on the next tick (bReloadScene)."""
        self._needs_rebuild = True

    def set_material_override(self, basecolor: float = 1.0,
                              metallic: float = 1.0, specular: float = 1.0,
                              roughness: float = 1.0) -> None:
        """The Details panel's push-constant override scalars
        (XkGlobalConstants, ZeldaEngine.cpp:903-919)."""
        self.material_overrides = np.asarray(
            [basecolor, metallic, specular, roughness], np.float32
        )

    def orbit(self, delta_yaw: float, delta_pitch: float) -> None:
        self.world.main_camera.add_movement(delta_yaw, delta_pitch)

    def zoom(self, delta: float) -> None:
        self.world.main_camera.zoom(delta)

    def toggle_stage_roll(self) -> None:  # 'M' key
        self.play_stage_roll = not self.play_stage_roll

    def toggle_light_roll(self) -> None:  # 'L' key
        self.play_light_roll = not self.play_light_roll

    def toggle_game_mode(self) -> None:  # 'G' key (:1795)
        self.game_mode = not self.game_mode

    def focus(self, target=(0.0, 0.0, 0.0)) -> None:
        """'F' key (:1779): re-aim the orbit camera at a target, keeping
        the arm length."""
        cam = self.world.main_camera
        arm = cam.arm_length
        direction = cam.direction
        cam.lookat = np.asarray(target, np.float32)
        cam.position = cam.lookat - direction * arm

    def reset_animation(self) -> None:  # 'R' key (:1786)
        self.roll_stage = 0.0
        self.roll_light = 0.0
        self._start_time = time.time()

    def set_wireframe(self, enabled: bool) -> None:
        """ENABLE_WIREFRAME toggle (the reference bakes it at compile
        time, ZeldaEngine.cpp:90): a config swap, like resize."""
        if enabled == self.config.wireframe:
            return
        with self.lock:
            self.config = self.config.replace(wireframe=enabled)
            self._drain_present()

    def resize(self, width: int, height: int) -> None:
        """Runtime resolution change - the RecreateSwapChain analogue
        (ZeldaEngine.cpp:2311-2335). Frames in flight are dropped (their
        shape is stale) - the reference's full-fence wait before
        RecreateSwapChain."""
        if (width, height) == (self.config.width, self.config.height):
            return
        with self.lock:
            self.config = self.config.replace(width=width, height=height)
            self._drain_present()

    def profile_passes(self, reps: int = 3) -> dict:
        """Per-pass ms breakdown of the current scene/view; stores the
        result in ``stats.pass_ms`` and returns it."""
        from zeldaengine_tpu_torch.profiling import profile_passes

        with self.lock:
            view = build_view_state(
                self.world, self.config, time=0.0,
                debug_view=self.debug_view, device=self.device)
            scene, meta, config = self.scene, self.meta, self.config
        self.stats.pass_ms = profile_passes(scene, view, meta, config,
                                            reps=reps)
        return self.stats.pass_ms

    # ----------------------------------------------------------------- frame

    def _start_fetch(self, device_img: torch.Tensor):
        """Queue the device->host copy of a presented frame behind it on
        the stream. The item keeps the device frame referenced until the
        fetch thread has waited for the copy."""
        if device_img.device.type != "cuda":
            return device_img, None, device_img
        host = torch.empty(device_img.shape, dtype=torch.uint8,
                           pin_memory=True)
        host.copy_(device_img, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, device_img

    @staticmethod
    def _fetch(item) -> np.ndarray:
        """The fetch thread's wait for one frame's host copy."""
        host, done, _device_img = item
        if done is not None:
            done.synchronize()
        return host.numpy()

    def _fetch_loop(self, q: queue.Queue) -> None:
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                seq, pending = item
                try:
                    img = self._fetch(pending)
                except Exception as e:  # noqa: BLE001 - raised by tick
                    LOG.exception("[PRESENT] frame fetch failed")
                    with self._present_cond:
                        self._fetch_error = e
                        self._present_cond.notify_all()
                    return
                with self._present_cond:
                    if seq >= self._drain_seq:  # not dropped by a drain
                        self._fetched[seq] = img
                    self._present_cond.notify_all()
            finally:
                q.task_done()

    def _present_async(self, device_img: torch.Tensor,
                       drains: int) -> np.ndarray:
        """Swapchain-style present (MAX_FRAMES_IN_FLIGHT semantics,
        ZeldaEngine.cpp:77; present modes :6589-6599): queue the frame for
        the fetch thread and return the frame the present mode names (see
        the module docstring). ``drains`` is the drain count when the
        frame's config was read."""
        depth = max(self.config.frames_in_flight, 1)
        if self._present_q is None:
            self._present_q = queue.Queue(maxsize=depth)
            self._fetch_thread = threading.Thread(
                target=self._fetch_loop, args=(self._present_q,),
                daemon=True)
            self._fetch_thread.start()
        pending = self._start_fetch(device_img)
        with self._present_cond:
            self._seq += 1
            seq = self._seq
            stale = self._drains != drains
            if stale:
                # A resize, wireframe toggle or rebuild from another thread
                # landed while this frame rendered: it is stale for every
                # later tick. Present it directly; later ticks start after.
                self._drain_seq = seq + 1
        if stale:
            return self._fetch(pending)
        item = (seq, pending)
        mailbox = self.config.present_mode == "mailbox"
        if mailbox:
            while True:
                try:
                    self._present_q.put_nowait(item)
                    break
                except queue.Full:
                    try:  # replace the stalest pending frame (mailbox)
                        self._present_q.get_nowait()
                        self._present_q.task_done()
                        self.stats.presents_dropped += 1
                    except queue.Empty:
                        pass  # the fetch thread took it; retry the put
        else:
            self._put_fifo(item)
        with self._present_cond:
            while True:
                self._check_fetch()
                if self._drain_seq > seq:
                    # A resize or rebuild from another thread dropped this
                    # frame while it was pending: present it directly.
                    break
                if mailbox and self._fetched:
                    shown = max(self._fetched)
                    break
                want = max(self._drain_seq, seq - depth + 1)
                if not mailbox and want in self._fetched:
                    shown = want
                    break
                self._present_cond.wait(1.0)
            if self._drain_seq <= seq:
                for s in [s for s in self._fetched if s < shown]:
                    del self._fetched[s]
                return self._fetched[shown]
        return self._fetch(item[1])

    def _put_fifo(self, item) -> None:
        """Blocking put at the queue's depth, raising if the fetch thread
        failed while the queue was full."""
        while True:
            try:
                self._present_q.put(item, timeout=1.0)
                return
            except queue.Full:
                with self._present_cond:
                    self._check_fetch()

    def _check_fetch(self) -> None:
        """Raise a fetch thread's failure (caller holds _present_cond)."""
        if self._fetch_error is not None:
            err, self._fetch_error = self._fetch_error, None
            self._present_q = None  # the thread has ended
            raise RuntimeError("present: frame fetch failed") from err
        if not self._fetch_thread.is_alive():
            raise RuntimeError("present: the fetch thread has ended")

    def _drain_present(self) -> None:
        """Drop queued and fetched frames (shape or content changes)."""
        q = self._present_q
        if q is not None:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
                q.task_done()
        with self._present_cond:
            self._fetched.clear()
            self._drain_seq = self._seq + 1
            self._drains += 1

    def tick(self) -> np.ndarray:
        """One DrawFrame: poll livelink, update animation state, render,
        present. Returns the (H, W, 3) uint8 frame the present mode
        names."""
        now = time.time()
        dt = now - self._last_time
        self._last_time = now

        if self.server is not None:
            raw = self.server.poll()
            if raw is not None:
                try:
                    with self.lock:
                        self.world.load(raw_data=raw)
                        self._rebuild_scene()
                    self.stats.reloads += 1
                except Exception:  # noqa: BLE001 - bad JSON must not kill us
                    LOG.exception("[WORLD] livelink reload failed")
        if self._needs_rebuild:
            with self.lock:
                self._needs_rebuild = False
                self._rebuild_scene()
                self.stats.reloads += 1

        if self.play_stage_roll:
            self.roll_stage += dt * np.radians(15.0)  # :4612
        if self.play_light_roll:
            self.roll_light += dt  # :4603

        with self.lock:
            config, scene, meta = self.config, self.scene, self.meta
            right = 0.0 if self.game_mode else (
                config.width * self.editor_right_frac)
            bottom = 0.0 if self.game_mode else (
                config.height * self.editor_bottom_frac)
            view = build_view_state(
                self.world,
                config,
                time=now - self._start_time,
                roll_stage=self.roll_stage,
                roll_light=self.roll_light,
                debug_view=self.debug_view,
                right_bar=right,
                bottom_bar=bottom,
                overrides=self.material_overrides,
                device=self.device,
            )
            overrides = self.material_overrides
            drains = self._drains
        t0 = time.time()
        if scene.cube_const is not None and float(overrides[3]) != 1.0:
            # The Details-panel roughness override can push roughness
            # below the scene's build-time minimum (1.0): the fixed-lod
            # reflection tier no longer applies; take the variable-lod
            # cube_pair1 gather.
            scene = scene._replace(cube_const=None)
        color, aux = render_frame(scene, view, meta, config)
        if config.validation and "validation" in aux:
            # Surface the validation counters (GetStats / log on trip).
            self.stats.validation = {
                k: int(v) for k, v in aux["validation"].items()
            }
            tripped = {k: v for k, v in self.stats.validation.items()
                       if v != 0}
            if tripped:
                LOG.warning("[VALIDATION] %s", tripped)
        device_img = _present_u8(color)
        if config.frames_in_flight > 1:
            img = self._present_async(device_img, drains)
        else:
            img = device_img.cpu().numpy()
        frame_s = time.time() - t0
        self.stats.frame_index += 1
        self.stats.frame_ms = frame_s * 1000.0
        self.stats.fps = 1.0 / max(frame_s, 1e-9)
        return img

    def run(
        self,
        frames: int = 0,
        on_frame: Optional[Callable[[np.ndarray, FrameStats], None]] = None,
    ) -> None:
        """MainTick loop; frames=0 means run until interrupted."""
        self.start()
        try:
            i = 0
            while frames == 0 or i < frames:
                img = self.tick()
                if on_frame is not None:
                    on_frame(img, self.stats)
                i += 1
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="ZeldaEngine on PyTorch + CUDA")
    parser.add_argument("--world", type=str, default=None,
                        help="path to a World.json")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--out", type=str, default=None,
                        help="write the last frame to this PNG")
    parser.add_argument("--port", type=int, default=8080,
                        help="livelink TCP port (0: a free port)")
    parser.add_argument("--assets", type=str, nargs="*", default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu' (plain PyTorch versions)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    config = EngineConfig(width=args.width, height=args.height)
    world = World(file_path=args.world).load() if args.world else None
    engine = Engine(config=config, world=world, asset_roots=args.assets,
                    livelink_port=args.port, device=args.device)
    last = {}

    def on_frame(img, stats):
        last["img"] = img
        if stats.frame_index % 10 == 0:
            LOG.info("frame %d: %.1f ms (%.1f fps), %d tris",
                     stats.frame_index, stats.frame_ms, stats.fps,
                     stats.triangles)

    engine.run(frames=args.frames, on_frame=on_frame)
    if args.out and "img" in last:
        from zeldaengine_tpu_torch.utils import write_png

        write_png(args.out, last["img"])
        LOG.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
