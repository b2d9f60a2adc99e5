"""walk_stats CLI - the strip walk's floor, the counterpart of the JAX
package's ``tools/walk_stats.py``.

Counts the (pixel, pair) tests the strip walk of kernels ``pair_raster``
and ``pair_raster_fused`` makes on the GBuffer pass's pairs exactly
(``ops/rasterize_cuda.py::strip_walk_tests``), converts them to fp32
operations (``OPS_PER_TEST``) and divides by the card's measured fused
multiply-add rate (kernel ``fma_peak``, ``csrc/fma_peak.cu``: C independent
FMA chains an element). If that floor is near kernel ``pair_raster_fused``'s
time, its gains must come from fewer tests, not from tuning the kernel.

    python -m zeldaengine_tpu_torch.tools.walk_stats [--scene demo|c4] \\
        [--grass 10000] [--rocks 65] [--steps 2048] [--device cuda|cpu]

``demo``: bench config 3 (the demo scene at 1920x1080, 64x32 tiles);
``c4``: bench config 4 (1,030,400 triangles in meshlets at 1024x1024,
32x128 tiles). The view is at time 0 with light capacities (8, 16, 8), as
the JAX tool sets it. The pairs are binned by the port's own frame
(``render_frame``: vertex stage, setup, culls, compaction, ``build_pairs``)
and taken where it calls ``pair_raster_fused``. Prints one JSON line:
``scene``, ``live_pairs``, ``tile``, ``pixel_pair_tests``,
``ops_per_test``, ``elem_ops``, ``fma_ops_per_s_chain{1,3,8}`` (FMAs a
second, an FMA counted as one operation, as the JAX tool counts its
element-ops), ``floor_ms_ilp3`` and ``floor_ms`` (``elem_ops`` at the
3- and 8-chain rates), ``record_bytes`` (the bytes the walk stages: 48 of
raster words and 16 of strip span a (tile, pair) entry), ``k2_ms`` and
``k2_over_floor``. With ``--device cpu`` everything runs in plain PyTorch
and the times are the host's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time

import numpy as np
import torch

from zeldaengine_tpu_torch.math.transforms import fma_f32_plain
from zeldaengine_tpu_torch.ops import KERNEL_WRAPPERS, _build
from zeldaengine_tpu_torch.ops import rasterize_cuda as rc
from zeldaengine_tpu_torch.utils.device import require_device

# fp32 operations of one (pixel, pair) test, an FMA counted as two (a
# multiply and an add, as the published fp32 peak counts it): 3 edge
# functions (2 mul + 2 add each), depth (3 mul + 2 add), edge sum (2), edge
# min (2), five compares and the select. The walk issues them as 6 FMAs, 4
# multiplies, 5 adds, 2 mins, 5 compares and 2 selects (csrc/strip_walk.cuh).
OPS_PER_TEST = 26
CHAINS = (1, 3, 8)
N_OPS = 64
# Kernel fma_peak's input: the JAX tool's (steps * 256, 128) f32 ones.
BLOCK = (256, 128)
STEPS = 2048
# Bytes the walk stages a (tile, pair) entry: the 12 raster words, and the
# 16-byte group holding the strip span when the records carry one.
RASTER_BYTES = 48
SPAN_BYTES = 16


def chain_constants(chains: int) -> tuple:
    """(start multipliers, mult, add) rounded to fp32 as the JAX tool's
    weak-typed Python floats are: f32(1 + 1e-6 c), f32(1.000001),
    f32(0.3)."""
    start = [float(np.float32(1.0 + 1e-6 * c)) for c in range(chains)]
    return start, float(np.float32(1.000001)), float(np.float32(0.3))


def _check_chains(chains: int, n_ops: int) -> None:
    if chains not in CHAINS:
        raise ValueError(f"chains must be one of {CHAINS}, got {chains}")
    if n_ops < 1:
        raise ValueError(f"n_ops must be >= 1, got {n_ops}")


def fma_peak_plain(a: torch.Tensor, chains: int,
                   n_ops: int = N_OPS) -> torch.Tensor:
    """Plain PyTorch version of ``fma_peak`` (any device): every step
    through ``fma_f32_plain`` (one rounding), the chains summed in order."""
    _check_chains(chains, n_ops)
    start, mult, add = chain_constants(chains)
    xs = [fma_f32_plain(a, m, add) for m in start]
    for _ in range(n_ops - 1):
        xs = [fma_f32_plain(x, mult, add) for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def fma_peak(a: torch.Tensor, chains: int, n_ops: int = N_OPS,
             backend: str = "auto") -> torch.Tensor:
    """T2's function, elementwise on f32 ``a``: tensors on the card go to
    kernel ``fma_peak`` (contiguous, 16-byte aligned, a multiple of 4
    elements), CPU tensors (or ``backend="torch"``) to ``fma_peak_plain``."""
    _check_chains(chains, n_ops)
    if not rc._use_kernel(a, backend):
        return fma_peak_plain(a, chains, n_ops)
    ptr = rc._check(a, "a", torch.float32, dev=a.device)
    if a.numel() % 4 or ptr % 16:
        raise ValueError("fma_peak: expected a multiple of 4 elements, "
                         "16-byte aligned")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    start, mult, add = chain_constants(chains)
    with torch.cuda.device(a.device):
        code = _build.load().zk_fma_peak(
            ptr, out.data_ptr(), a.numel(), chains, n_ops,
            (ctypes.c_float * len(start))(*start), mult, add,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "fma_peak")
    fma_peak.launches += 1
    return out


fma_peak.launches = 0
KERNEL_WRAPPERS["fma_peak"] = fma_peak


def _median_ms(fn, reps: int, dev: torch.device) -> float:
    """Median ms of ``reps`` single calls after one warm-up: CUDA events
    around each on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fma_rate(chains: int, n_ops: int = N_OPS, steps: int = STEPS,
             reps: int = 5, device="cuda") -> dict:
    """The measured FMA rate of ``chains`` chains on the JAX tool's input
    (``steps`` blocks of (256, 128) f32 ones): ``ms`` the median launch,
    ``fma_ops_per_s`` elements x n_ops x chains over it."""
    dev = require_device(device)
    a = torch.ones((steps * BLOCK[0], BLOCK[1]), dtype=torch.float32,
                   device=dev)
    ms = _median_ms(lambda: fma_peak(a, chains, n_ops), reps, dev)
    return dict(chains=chains, n_ops=n_ops, elements=a.numel(), ms=ms,
                fma_ops_per_s=a.numel() * n_ops * chains / (ms * 1e-3))


def frame_passes(scene, meta, world, config) -> dict:
    """The pair streams of one frame at the JAX tool's view (time 0, light
    capacities (8, 16, 8)), binned by ``render_frame`` and taken at its
    first call of each raster kernel: ``"shadow"`` (``pair_raster``, the
    shadow pass) and ``"gbuffer"`` (``pair_raster_fused``), each (pairs,
    padded height, padded width, the kernel's keyword arguments)."""
    # Imported here: ops/__init__.py imports this module.
    from zeldaengine_tpu_torch.passes import frame
    from zeldaengine_tpu_torch.passes.view import build_view_state

    view = build_view_state(world, config, time=0.0,
                            light_capacities=(8, 16, 8),
                            device=scene.pair_pos.device)
    noted = {}
    saved = {}

    def noting(key, name):
        fn = saved[name] = getattr(frame, name)

        def call(pairs, height, width, **kw):
            noted.setdefault(key, (pairs, height, width, {
                k: v for k, v in kw.items() if k != "backend"}))
            return fn(pairs, height, width, **kw)
        setattr(frame, name, call)

    noting("shadow", "rasterize_pairs")
    noting("gbuffer", "rasterize_pairs_fused")
    try:
        frame.render_frame(scene, view, meta, config)
    finally:
        for name, fn in saved.items():
            setattr(frame, name, fn)
    return noted


def gbuffer_pass(scene, meta, world, config) -> tuple:
    """``frame_passes``' GBuffer pass: (pairs, padded height, padded width,
    kernel ``pair_raster_fused``'s keyword arguments)."""
    passes = frame_passes(scene, meta, world, config)
    if "gbuffer" not in passes:
        raise RuntimeError("the frame made no GBuffer pass through "
                           "pair_raster_fused (raster route 'planes')")
    return passes["gbuffer"]


def walk_load(pairs, height: int, width: int, kw: dict) -> dict:
    """The strip walk's exact load on a pair stream: (pixel, pair) tests
    (``rc.strip_walk_tests``), their fp32 operations, the (tile, pair)
    entries walked and the bytes staged for them."""
    th, tw = kw["tile_h"], kw["tile_w"]
    y_row = kw.get("y_row", -1)
    tests = int(rc.strip_walk_tests(
        pairs, height, width, th, tw, kw.get("sub_rows", 8), y_row,
        kw.get("y0_tiles", 0)).sum())
    tiles, _ = rc._tile_pair_list(pairs, height // th, width // tw, th, tw)
    entries = int(tiles.numel())
    staged = RASTER_BYTES + (SPAN_BYTES if y_row >= 0 else 0)
    return dict(live_pairs=int(pairs.gbounds[1]), tile=[th, tw],
                pixel_pair_tests=tests, ops_per_test=OPS_PER_TEST,
                elem_ops=tests * OPS_PER_TEST, tile_pair_entries=entries,
                record_bytes=entries * staged)


def report(scene_name: str, pairs, height: int, width: int, kw: dict,
           rates: dict, k2_reps: int = 20) -> dict:
    """The tool's line for one pair stream: its walk load, the floor at
    the measured rates (``rates[c]``: ``fma_rate``'s result at c chains)
    and kernel ``pair_raster_fused``'s time on it (median of ``k2_reps``
    single calls)."""
    load = walk_load(pairs, height, width, kw)
    ms = _median_ms(lambda: rc.rasterize_pairs_fused(
        pairs, height, width, **kw), k2_reps, pairs.records.device)
    floor = {c: load["elem_ops"] / rates[c]["fma_ops_per_s"] * 1e3
             for c in CHAINS}
    out = dict(scene=scene_name, **load)
    for c in CHAINS:
        out[f"fma_ops_per_s_chain{c}"] = rates[c]["fma_ops_per_s"]
    out.update(floor_ms_ilp3=floor[3], floor_ms=floor[8], k2_ms=ms,
               k2_over_floor=ms / floor[8] if floor[8] > 0 else None)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="walk_stats")
    parser.add_argument("--scene", default="demo", choices=("demo", "c4"))
    parser.add_argument("--grass", type=int, default=10000)
    parser.add_argument("--rocks", type=int, default=65)
    parser.add_argument("--steps", type=int, default=STEPS,
                        help="kernel fma_peak's input: steps x (256, 128)")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dev = require_device(args.device)

    from zeldaengine_tpu_torch.scene import build_demo_scene
    from zeldaengine_tpu_torch.tools._scenes import (
        config3, config4, config4_scene)

    if args.scene == "c4":
        config = config4()
        scene, meta, world, _ = config4_scene(config, device=dev)
    else:
        config = config3()
        scene, meta, world = build_demo_scene(
            config, grass=args.grass, rocks=args.rocks, device=dev)
    pairs, height, width, kw = gbuffer_pass(scene, meta, world, config)
    rates = {c: fma_rate(c, steps=args.steps, reps=args.reps, device=dev)
             for c in CHAINS}
    out = report(args.scene, pairs, height, width, kw, rates)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu (plain PyTorch, host clock)")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
