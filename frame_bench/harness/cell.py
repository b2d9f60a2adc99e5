"""One run of one cell: set-up, the timed window, then the check against
the plain reference and the per-layer metrics.

A cell's configuration file names its entry:

- ``engine_tick``: ``Engine`` (the viewer's engine) at the configuration's
  settings, its livelink on a free port, driven one ``Engine.tick`` a frame;
  the traffic moves its camera through ``Engine.orbit`` or pushes worlds
  over the livelink. The harness wraps the name ``render_frame`` that the
  engine module calls, to keep the last frames' buffers for the check
  (every run) and to time the call (the traced run's untraced part).
- ``render_frame``: the scene built once from the configuration's scene
  description, then ``build_view_state`` and ``render_frame`` a frame, the
  camera orbiting as the traffic says (bench.py's per-frame loop).

Every frame is issued when the last call returns, with no synchronise in
between; a CUDA event recorded after each frame gives its completion on
the device.
"""

from __future__ import annotations

import collections
import gc
import json
import statistics
import time
from typing import Optional

import numpy as np
import torch

from frame_bench.harness import check, spec
from frame_bench.harness import trace as trace_mod
from frame_bench.harness.traffic import Traffic
from frame_bench.harness.wire import Pusher

# Frames the check samples in a run, at fractions of the window drawn from
# the seed.
SAMPLES = 3
# Frames of the cell's own traffic run before the window (set-up).
WARM_FRAMES = 24
# Seconds of frames a --trace 1 run traces after its window; the window's
# own frames give the host spans.
TRACE_SECONDS = 2.0
# The last frames an Engine cell keeps, to find the one a presented image
# shows (mailbox present returns the newest frame fetched so far).
RING = 4
# Traced frames whose raster work the rooflines count.
ROOFLINE_FRAMES = 8
# The clock the render_frame entry hands build_view_state: frame k is at
# k / 60 s.
FRAME_TIME_S = 1.0 / 60.0
# The buffers of a frame the check compares (aux keys of render_frame).
KEPT = ("shadowmap", "gbuffer_depth", "tri_id", "shadow_factor",
        "pair_overflow", "compact_overflow")
# The name an Engine cell wraps to keep each frame's buffers.
HOOK = "zeldaengine_tpu_torch.engine.render_frame"


class HookError(RuntimeError):
    """The engine rendered frames without calling ``HOOK``."""


def _kept(color, aux) -> dict:
    out = {k: aux[k] for k in KEPT}
    out["color"] = color
    return out


class FrameTap:
    """Stands in for ``render_frame`` under the engine module's name: calls
    it, keeps the last ``RING`` frames' buffers (references only, no work
    on the device), times the call while ``clock`` is set and keeps every
    frame's view while ``keep_views`` is set."""

    def __init__(self, fn):
        self.fn = fn
        self.ring = collections.deque(maxlen=RING)
        self.index = 0
        self.clock = False
        self.render_s = []
        self.keep_views = False
        self.views = []

    def __call__(self, scene, view, meta, config):
        t0 = time.perf_counter() if self.clock else None
        color, aux = self.fn(scene, view, meta, config)
        if t0 is not None:
            self.render_s.append(time.perf_counter() - t0)
        self.ring.append((self.index, view, _kept(color, aux)))
        if self.keep_views:
            self.views.append((self.index, view))
        self.index += 1
        return color, aux


def _load_kernels(device: torch.device) -> None:
    if device.type == "cuda":
        from zeldaengine_tpu_torch.ops import _build
        _build.load()


class EngineEntry:
    """The ``engine_tick`` entry."""

    def __init__(self, cfg: dict, traffic: Traffic, device, parts: dict):
        from frame_bench.reference.render import world_from_doc
        self.cfg, self.traffic, self.device = cfg, traffic, device
        t = time.perf_counter()
        import zeldaengine_tpu_torch.engine as engine_mod
        from zeldaengine_tpu_torch.config import EngineConfig
        from zeldaengine_tpu_torch.scene.world import World
        parts["import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        _load_kernels(device)
        parts["kernel_load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.engine_mod = engine_mod
        self.tap = FrameTap(engine_mod.render_frame)
        engine_mod.render_frame = self.tap
        self.engine = engine_mod.Engine(
            config=EngineConfig(**cfg["settings"]),
            world=World().load(raw_data=json.dumps(cfg["world"])),
            livelink_port=0, device=device)
        self.engine.start()
        parts["scene_build_s"] = time.perf_counter() - t
        parts["meshlet_bake_s"] = 0.0
        self.pusher = None
        self.push_cams = None
        if traffic.push_interval:
            # Worlds for the warm-up and the longest window (51 s), with
            # room to spare.
            n = int((51 + 30) / traffic.push_interval)
            cam = world_from_doc(cfg["world"]).main_camera
            self.push_cams = traffic.push_cameras(cam, n)
            payloads = []
            for pos in self.push_cams:
                doc = dict(cfg["world"])
                doc["MainCamera"] = dict(doc["MainCamera"],
                                         Position=[float(v) for v in pos])
                payloads.append(json.dumps(doc).encode("utf-8"))
            self.pusher = Pusher(payloads, traffic.push_interval,
                                 self.engine.server.port)
            self.pusher.start()
        first, self.step_yaw = traffic.frame_yaws()
        self.first_yaw = first
        self.k = 0

    def step(self):
        if self.push_cams is None:
            self.engine.orbit(self.first_yaw if self.k == 0
                              else self.step_yaw, 0.0)
        reloads = self.engine.stats.reloads
        img = self.engine.tick()
        self.k += 1
        return img, self.engine.stats.reloads != reloads

    def snapshot(self, out):
        sent = self.pusher.sent if self.pusher else 0
        return dict(ring=list(self.tap.ring), presented=out[0], sent=sent,
                    calls=self.tap.index, ticks=self.k)

    def set_clock(self, on: bool) -> None:
        self.tap.clock = on

    def set_keep_views(self, on: bool) -> None:
        self.tap.keep_views = on

    def traced(self) -> list:
        return list(self.tap.views)

    def render_spans(self) -> list:
        return self.tap.render_s

    def close(self) -> Optional[BaseException]:
        err = None
        if self.pusher is not None:
            self.pusher.stop()
            err = self.pusher.error
        self.engine.stop()
        self.engine_mod.render_frame = self.tap.fn
        return err

    def release(self) -> None:
        """Drop the program's state; the traced views stay."""
        self.tap.ring.clear()
        self.engine = None

    # ------------------------------------------------------------- check

    def resolve(self, snap: dict, quantize) -> tuple:
        """(frame index, view, kept buffers, presented u8 or None) of the
        frame a sample's presented image shows; the newest kept frame with
        no presented image where none of the kept frames matches it.

        Raises ``HookError`` where the engine rendered without calling the
        name ``render_frame`` of its module (the ring is empty, or saw
        fewer calls than ticks by more than it keeps): an engine that
        replays its frame another way has to keep that name on its path,
        or give the benchmark another way to read a frame's buffers."""
        if not snap["ring"] or snap["ticks"] - snap["calls"] > RING:
            raise HookError(
                f"{HOOK} saw {snap['calls']} calls in {snap['ticks']} ticks: "
                "the engine rendered without it, so the check has no "
                "frame's buffers to compare")
        shown = torch.from_numpy(np.ascontiguousarray(snap["presented"]))
        for idx, view, kept in reversed(snap["ring"]):
            u8 = quantize(kept["color"])
            if u8.shape == shown.shape and torch.equal(
                    u8, shown.to(u8.device)):
                return idx, view, kept, u8
        idx, view, kept = snap["ring"][-1]
        return idx, view, kept, None

    def inputs(self, idx: int, view, sent: Optional[int] = None):
        """(camera position, world document) of frame ``idx`` for the
        reference, or None where the frame's world cannot be named."""
        from frame_bench.reference.render import orbit_positions
        if self.push_cams is None:
            pos = orbit_positions(self.cfg["world"], self.first_yaw,
                                  self.step_yaw, idx + 1)[idx]
            return pos, self.cfg["world"]
        cam = view.camera_pos.detach().cpu().numpy().astype(np.float32)
        hits = np.flatnonzero((self.push_cams == cam[None]).all(axis=1))
        if hits.size == 0 or (sent is not None and hits[0] >= sent):
            return None
        doc = dict(self.cfg["world"])
        doc["MainCamera"] = dict(
            doc["MainCamera"],
            Position=[float(v) for v in self.push_cams[hits[0]]])
        return self.push_cams[hits[0]], doc


class FrameEntry:
    """The ``render_frame`` entry."""

    def __init__(self, cfg: dict, traffic: Traffic, device, parts: dict):
        from frame_bench.reference.render import (
            orbit_positions, sphere_grid_meshes)
        self.cfg, self.traffic, self.device = cfg, traffic, device
        t = time.perf_counter()
        from zeldaengine_tpu_torch.config import EngineConfig
        from zeldaengine_tpu_torch.meshlet import build_meshlets
        from zeldaengine_tpu_torch.passes.frame import render_frame
        from zeldaengine_tpu_torch.passes.view import build_view_state
        from zeldaengine_tpu_torch.scene import SceneBuilder
        from zeldaengine_tpu_torch.scene.world import World
        parts["import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        _load_kernels(device)
        parts["kernel_load_s"] = time.perf_counter() - t
        self.render_frame = render_frame
        self.build_view_state = build_view_state
        self.config = EngineConfig(**cfg["settings"])
        self.world = World().load(raw_data=json.dumps(cfg["world"]))
        desc = cfg["scene"]
        t = time.perf_counter()
        if desc["kind"] == "world":
            # The world document's objects, as Engine() builds them.
            from zeldaengine_tpu_torch.scene.assets import (
                build_scene_from_world)
            parts["meshlet_bake_s"] = 0.0
            self.scene, self.meta = build_scene_from_world(
                self.world, self.config, roots=[], device=device)
        elif desc["kind"] == "sphere_grid":
            mesh, offsets = sphere_grid_meshes(desc)
            b = SceneBuilder(self.config)
            mat = b.add_material({})
            baked = [build_meshlets(mesh.positions + off, mesh.indices,
                                    normals=mesh.normals, uvs=mesh.uvs)
                     for off in offsets]
            parts["meshlet_bake_s"] = time.perf_counter() - t
            t = time.perf_counter()
            for ms in baked:
                b.add_meshlet_object(ms, mat)
            self.scene, self.meta = b.build(device)
        else:
            raise ValueError(f"render_frame entry: scene {desc['kind']!r}")
        parts["scene_build_s"] = time.perf_counter() - t
        self.first_yaw, self.step_yaw = traffic.frame_yaws()
        self._positions = orbit_positions
        self.cams = np.empty((0, 3), np.float32)
        self.k = 0
        self.last = None
        self.clock = False
        self.render_s = []
        self.keep_views = False
        self.views = []

    def camera(self, k: int) -> np.ndarray:
        if k >= len(self.cams):
            self.cams = self._positions(self.cfg["world"], self.first_yaw,
                                        self.step_yaw, 2 * k + 1024)
        return self.cams[k]

    def step(self):
        k = self.k
        self.world.main_camera.position = self.camera(k).copy()
        view = self.build_view_state(self.world, self.config,
                                     time=k * FRAME_TIME_S,
                                     device=self.device)
        t0 = time.perf_counter() if self.clock else None
        color, aux = self.render_frame(self.scene, view, self.meta,
                                       self.config)
        if t0 is not None:
            self.render_s.append(time.perf_counter() - t0)
        self.last = (k, _kept(color, aux))
        if self.keep_views:
            self.views.append((k, None))
        self.k += 1
        return None, False

    def snapshot(self, out):
        return dict(frame=self.last)

    def set_clock(self, on: bool) -> None:
        self.clock = on

    def set_keep_views(self, on: bool) -> None:
        self.keep_views = on

    def traced(self) -> list:
        return list(self.views)

    def render_spans(self) -> list:
        return self.render_s

    def close(self):
        return None

    def release(self) -> None:
        self.scene = self.meta = self.last = None

    def resolve(self, snap: dict, quantize) -> tuple:
        idx, kept = snap["frame"]
        return idx, None, kept, None

    def inputs(self, idx: int, view, sent=None):
        return self.camera(idx), self.cfg["world"]


ENTRIES = {"engine_tick": EngineEntry, "render_frame": FrameEntry}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One run: ``Run(...).execute()`` returns the result object."""

    def __init__(self, bench: dict, cell_name: str, seed: int,
                 seconds: float, trace: bool, device="cuda",
                 bench_dir=spec.BENCH_DIR, t_start: Optional[float] = None):
        self.bench = bench
        self.cell = spec.find_cell(bench, cell_name)
        self.cfg = spec.load_config(self.cell["config"], bench_dir)
        self.traffic = Traffic(spec.load_traffic(self.cell["traffic"],
                                                 bench_dir), seed)
        self.bench_dir = bench_dir
        self.seconds = float(seconds)
        self.trace_on = bool(trace)
        self.device = torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.parts = {}
        self.tick_s, self.reload_s = [], []
        self.samples = []
        self.trace = None
        self.traced_frames = 0
        self.roofline_frames = {}
        self.check_lines = []
        self.numbers = {}
        # The least share of a sampled frame's pixels that the settled
        # pixels' numbers judge (``check.settled_share``).
        self.settled = 1.0
        self.errors = []
        self.frames = 0
        self.fps = None
        self.frame_p95_ms = None
        self.memory_peak = None
        self.check_s = None
        self.frame_ends = []

    # ------------------------------------------------------------ window

    def _window(self, entry) -> None:
        """The timed window; under ``--trace 1`` the frames after it, for
        ``TRACE_SECONDS`` from the first, run under the profiler (started
        once the window has closed: starting it takes the card's tracer
        seconds)."""
        cuda = self.device.type == "cuda"
        at = [p * self.seconds for p in self.traffic.sample_points(SAMPLES)]
        events, si = [], 0
        entry.set_clock(self.trace_on)
        t0 = time.perf_counter()
        n = 0
        while True:
            ts = time.perf_counter()
            out = entry.step()
            te = time.perf_counter()
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            n += 1
            elapsed = te - t0
            self.frame_ends.append(elapsed)
            self.tick_s.append(te - ts)
            if out[1]:
                self.reload_s.append(te - ts)
            if si < len(at) and elapsed >= at[si]:
                self.samples.append(entry.snapshot(out))
                si += 1
            if elapsed >= self.seconds:
                break
        _sync(self.device)
        t1 = time.perf_counter()
        self.frames = n
        self.fps = n / (t1 - t0)
        if cuda and len(events) > 2:
            gaps = [events[i - 1].elapsed_time(events[i])
                    for i in range(1, len(events))]
            self.frame_p95_ms = statistics.quantiles(
                gaps, n=20, method="inclusive")[18]
        if cuda:
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        entry.set_clock(False)
        if self.trace_on:
            self._traced(entry)

    def _traced(self, entry) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        entry.set_keep_views(True)
        with record_function(trace_mod.WINDOW):
            t0 = time.perf_counter()
            n = 0
            while True:
                entry.step()
                n += 1
                if time.perf_counter() - t0 >= TRACE_SECONDS:
                    break
            _sync(self.device)
        prof.stop()
        entry.set_keep_views(False)
        self.traced_frames = n
        self.trace = trace_mod.reduce(prof)

    # ------------------------------------------------------------- check

    def _check(self, entry, ref) -> None:
        rows, unmatched, dropped = [], 0, 0
        for (idx, view, kept, u8), sent in self.samples:
            if view is not None and u8 is None:
                unmatched += 1
            inputs = entry.inputs(idx, view, sent)
            if inputs is None:
                unmatched += 1
                continue
            dropped += int(kept["pair_overflow"]) + int(
                kept["compact_overflow"])
            want = ref.render(*inputs, shadowmap=kept["shadowmap"])
            got = {k: kept[k] for k in ("shadowmap", "gbuffer_depth",
                                        "tri_id", "shadow_factor", "color")}
            if u8 is not None:
                got["u8"] = u8
            rows.append(check.frame_numbers(got, want))
            self.settled = min(self.settled, check.settled_share(want))
        self.numbers = check.worst(rows, dict(unmatched=unmatched,
                                              dropped=dropped))
        if not rows:
            self.errors.append("no sampled frame could be compared")

    def _rooflines(self, entry, ref) -> None:
        from frame_bench.metrics import _roofline
        tr = self.trace
        traced = entry.traced()
        if tr is None or not traced:
            return
        k2 = tr.starts_of(trace_mod.K2_NAMES)
        if len(k2) != len(traced):
            return  # not one GBuffer raster a frame: no pairing
        k2_s = tr.kernel_frames(trace_mod.K2_NAMES, k2)
        k1_s = tr.kernel_frames(trace_mod.K1_NAMES, k2)
        picks = np.unique(np.linspace(0, len(traced) - 1,
                                      min(ROOFLINE_FRAMES, len(traced)))
                          .round().astype(int))
        out = {"gbuffer": [], "shadow": []}
        for j in picks:
            idx, view = traced[j]
            inputs = entry.inputs(idx, view)
            if inputs is None:
                continue
            setups = ref.pass_setups(*inputs)
            for name, took in (("gbuffer", k2_s[j]), ("shadow", k1_s[j])):
                setup, w, h = setups[name]
                work = _roofline.pass_work(setup.valid, setup.bbox, w, h,
                                           name)
                out[name].append(dict(bound_s=_roofline.bound_s(work),
                                      kernel_s=took, **work))
        self.roofline_frames = out

    # --------------------------------------------------------------- run

    def execute(self) -> dict:
        # Interpreter start, torch's import and the card check.
        self.parts["start_s"] = time.perf_counter() - self.t_start
        entry = ENTRIES[self.cfg["entry"]](self.cfg, self.traffic,
                                           self.device, self.parts)
        t = time.perf_counter()
        for _ in range(WARM_FRAMES):
            entry.step()
        _sync(self.device)
        self.parts["warmup_s"] = time.perf_counter() - t
        self.setup_s = time.perf_counter() - self.t_start
        self._window(entry)
        err = entry.close()
        if err is not None:
            self.errors.append(f"pusher: {err!r}")
        self.render_s = list(entry.render_spans())
        from frame_bench.reference.render import Reference, quantize_u8
        # Each sample's frame is named while the kept frames are there;
        # then the program's state goes before the reference runs (a
        # process's peak memory never falls again).
        try:
            self.samples = [(entry.resolve(snap, quantize_u8),
                             snap.get("sent")) for snap in self.samples]
        except HookError as exc:
            self.errors.append(str(exc))
            self.samples = []
        entry.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = Reference(self.cfg, device=self.device)
        self._check(entry, ref)
        if self.trace_on:
            self._rooflines(entry, ref)
        self.check_s = time.perf_counter() - t
        self.samples = []
        return self.result()

    # ------------------------------------------------------------ result

    def result(self) -> dict:
        correct, lines = check.judge(self.numbers,
                                     check.limits_of(self.cfg))
        correct = correct and not self.errors
        self.check_lines = lines
        dev = self.device
        if dev.type == "cuda":
            device = dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                          count=1, memory_peak_bytes=self.memory_peak)
        else:
            device = dict(platform="cpu", kind="none", count=0,
                          memory_peak_bytes=None)
        metrics = {}
        breakdown = None
        if not self.trace_on:
            values = dict(fps=self.fps, frame_p95_ms=self.frame_p95_ms,
                          setup_s=self.setup_s)
            for m in spec.cell_metrics(self.bench, self.cell["name"],
                                       "end_to_end"):
                v = values.get(m["name"])
                if v is not None and (dev.type == "cuda"
                                      or m["source"] == "host_clock"):
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
        else:
            for m in spec.cell_metrics(self.bench, self.cell["name"],
                                       "per_layer"):
                if dev.type != "cuda" and m["source"] == "device_trace":
                    continue
                v = spec.load_reader(m["name"], self.bench_dir)(self)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
            if self.trace is not None and dev.type == "cuda":
                device["busy_s"] = self.trace.busy_s
                device["window_s"] = self.trace.window_s
                breakdown = dict(device_ops=self.trace.top_device_ops(),
                                 idle_gaps=self.trace.longest_gaps())
        out = dict(correct=bool(correct), attempted=self.frames,
                   failed=0 if correct else max(1, len(self.errors)),
                   metrics=metrics, device=device)
        if breakdown is not None:
            out["breakdown"] = breakdown
        out["setup_parts"] = dict(self.parts)
        out["check_s"] = self.check_s
        out["settled"] = self.settled
        if self.frame_ends and not self.trace_on:
            # Frames a second in consecutive 5-second slices of the window
            # (how steady the rate is inside one run).
            counts = collections.Counter(int(t // 5.0)
                                         for t in self.frame_ends)
            out["fps_slices"] = [counts[i] / 5.0
                                 for i in range(int(self.seconds // 5.0))]
        if self.tick_s:
            out["host_ticks"] = dict(
                n=len(self.tick_s),
                reloads=len(self.reload_s),
                mean_ms=1e3 * statistics.fmean(self.tick_s),
                median_ms=1e3 * statistics.median(self.tick_s),
                max_ms=1e3 * max(self.tick_s))
        if self.errors:
            out["errors"] = self.errors
        out["checked"] = {k: dict(value=v, limit=lim) for k, v, lim in lines}
        return out
