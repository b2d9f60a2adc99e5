"""Reduce a ``torch.profiler`` trace of the traced window to what the
per-layer metrics read: the device's busy time, its idle gaps, the host's
launch calls, and each raster kernel's device time frame by frame.

The window is the span of the harness's ``frame_bench.window`` annotation
(from the first traced frame's issue to the synchronise that closes it),
on the trace's own clock, which the device events share.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

WINDOW = "frame_bench.window"
# CPU-side calls that put work on the device: kernel launches, copies,
# sets and graph launches (runtime and driver API names).
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                   "cuMemcpy", "cuMemset", "cudaGraphLaunch",
                   "cuGraphLaunch")
K1_NAMES = ("pair_raster_kernel", "merge_parts_kernel")
K2_NAMES = ("pair_raster_fused_kernel",)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    launches: int
    device_ops: List[Tuple[str, float, float]]  # (name, start s, end s)
    host_ops: List[Tuple[str, float, float]]
    gaps: List[Tuple[float, float]]  # idle intervals inside the window

    def top_device_ops(self, k: int = 10) -> list:
        total = {}
        for name, a, b in self.device_ops:
            total[name] = total.get(name, 0.0) + (b - a)
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[name, sec] for name, sec in rows]

    def longest_gaps(self, k: int = 10) -> list:
        """The ``k`` longest idle gaps, each named by the innermost host
        operation running at its middle (what the host was doing) and the
        device operation that ended it."""
        starts = [a for _, a, _ in self.device_ops]
        out = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (a + b)
            host = min((op for op in self.host_ops if op[1] <= mid <= op[2]),
                       key=lambda op: op[2] - op[1], default=None)
            i = bisect.bisect_left(starts, b)
            after = (self.device_ops[i][0] if i < len(self.device_ops)
                     else "end")
            label = f"host {host[0] if host else 'idle'}; then {after}"
            out.append([label[:200], b - a])
        return out

    def kernel_frames(self, names, frame_ends: List[float]) -> Optional[list]:
        """Device seconds of the kernels whose name contains one of
        ``names``, frame by frame: ``frame_ends`` are the device start times
        of an operation that closes each frame (the GBuffer raster), and a
        kernel belongs to the first frame whose end it does not pass."""
        per = [0.0] * len(frame_ends)
        for name, a, b in self.device_ops:
            if any(n in name for n in names):
                i = bisect.bisect_left(frame_ends, a)
                if i < len(per):
                    per[i] += b - a
        return per

    def starts_of(self, names) -> List[float]:
        return [a for name, a, _ in self.device_ops
                if any(n in name for n in names)]


def _ns(evt, which: str) -> float:
    if which == "start":
        return float(evt.start_ns())
    return float(evt.start_ns() + evt.duration_ns())


def _annotation(evt) -> bool:
    """A user annotation (``record_function``), which the trace mirrors on
    the device's timeline: no device work."""
    flag = getattr(evt, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def reduce(prof) -> Optional[Trace]:
    """The trace of ``prof`` (a stopped ``torch.profiler.profile``) inside
    its ``frame_bench.window`` annotation, times in seconds from its
    start; None when the annotation is missing."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW]
    if not win:
        return None
    w0, w1 = _ns(win[0], "start"), _ns(win[0], "end")
    dev, host, launches = [], [], 0
    for e in events:
        a, b = _ns(e, "start"), _ns(e, "end")
        if b < w0 or a > w1:
            continue
        kind = str(e.device_type()).split(".")[-1]
        name = e.name()
        if name == WINDOW or _annotation(e):
            continue
        if kind == "CUDA":
            dev.append((name, (max(a, w0) - w0) * 1e-9,
                        (min(b, w1) - w0) * 1e-9))
        elif name.startswith(LAUNCH_PREFIXES):
            launches += 1
        else:
            host.append((name, (a - w0) * 1e-9, (b - w0) * 1e-9))
    dev.sort(key=lambda d: d[1])
    busy, gaps, cursor = 0.0, [], 0.0
    for _, a, b in dev:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    window_s = (w1 - w0) * 1e-9
    if window_s > cursor:
        gaps.append((cursor, window_s))
    return Trace(window_s=window_s, busy_s=busy, launches=launches,
                 device_ops=dev, host_ops=host, gaps=gaps)
