"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``zeldaengine_tpu_torch/csrc`` and drives the
port's paths through ``render_frame``: the 1920x1080 deferred demo frame of
bench config 3 at its defaults (10000 grass instances per species, 65
rocks, 16 point lights culled to 40x128 blocks and shaded by the
point-light kernel, tiles 64x32); the same frame with 512 point lights;
one frame through each opt-in PCF backend that has a kernel; bench config
3t (the same frame with per-slot PBR textures and the variable-lod cube
reflection); bench config 1 (a forward-shaded sphere at 512x512); bench
config 4 (16 spheres of 64,400 triangles baked by the native meshlet
builder, 1,030,400 triangles in 14,004 meshlets, culled by frustum and cone
tests and compacted every frame, at 1024x1024); bench config 5 through the
engine shell (512x512, mailbox present with two frames in flight, a world
streamed over the livelink every 50 ms); the editor protocol on the card
(an edit presents one tick later under fifo); and the
committed golden scene in debug views 0, 1, 4, 8 and 9, held against
tests/golden/*.png, and its view 0 once more with both passes' point lights
through the point-light kernel; and the remaining frame options on config
3's frame (phase ``options``: the dome mesh through the pair rasterizer with
ids and an initial depth, the background pass, the merged environment tap,
the occlusion early-out on aligned pair bins, config 3t's half-resolution
reflection, every ablation flag); and row bands (phase ``bands``: config
3's frame striped over four and eight bands and in four contiguous bands,
and config 5's world in four contiguous bands, through
``parallel/tiles.py`` on one card, each against the full frame; every
K1 / K2 band call replayed); and the JAX package's raster values (phase
``rasters``: config 3 at "pallas" and "fused", config 1 at "pallas" and
config 5's world at "jnp", each against its "auto" frame; every K1 and
fma call of those frames replayed); and the probe tools (phase ``probes``:
``tools/gather_probe.py`` at its 4096 tiles, both axes, K 1-128, kernel
gather_probe in each of its layouts with its byte and shared-memory
bounds; ``tools/walk_stats.py``'s FMA rate at 1, 3 and 8 chains,
kernel fma_peak, and the strip walk's floor on config 3's and config 4's
GBuffer pairs beside kernel pair_raster_fused's time; both kernels held
against their plain versions bit for bit). Every kernel is replayed on the inputs a
frame gave it and held against its plain PyTorch version on the card, and timed as
device time (its calls replayed from a CUDA graph, ``ms``) and as events around
eager calls (``eager_ms``, which includes the host's cost per call where that
is the larger); 256x256 frames rendered through the kernels are held against
the same frames rendered through the plain versions, and the engine shell
presents two 1080p frames under fifo and two at ``Engine()``'s defaults. Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It needs a CUDA device, nvcc, PyTorch, NumPy and
Pillow (the textured scene's and the goldens' PNGs).
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

# One card is used: unless the caller chose the cards, only the first is
# made visible, and the last line's ``count`` is that one card.
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zeldaengine_tpu_torch import EngineConfig, TEST_CONFIG  # noqa: E402
from zeldaengine_tpu_torch import native, ops  # noqa: E402
from zeldaengine_tpu_torch.engine import Engine  # noqa: E402
from zeldaengine_tpu_torch.livelink import (  # noqa: E402
    editor_request, send_data_to_engine)
from zeldaengine_tpu_torch.math import transforms  # noqa: E402
from zeldaengine_tpu_torch.ops import _build  # noqa: E402
from zeldaengine_tpu_torch.ops import lighting, lighting_cuda  # noqa: E402
from zeldaengine_tpu_torch.ops import pcf_cuda, rasterize as rast  # noqa: E402
from zeldaengine_tpu_torch.ops import pcf_tables, pcf_window  # noqa: E402
from zeldaengine_tpu_torch.ops import rasterize_cuda as rc  # noqa: E402
from zeldaengine_tpu_torch.ops import shadow, window_tap  # noqa: E402
from zeldaengine_tpu_torch.parallel import (  # noqa: E402
    band_pair_stats, make_tile_mesh, render_frame_sharded, stripe_layout)
from zeldaengine_tpu_torch.passes import build_view_state, render_frame  # noqa: E402
from zeldaengine_tpu_torch.passes import frame as frame_graph  # noqa: E402
from zeldaengine_tpu_torch.scene import (  # noqa: E402
    CameraDesc, LightDesc, SceneBuilder, World, build_demo_scene,
    build_textured_demo_scene, make_demo_world, make_sphere)
from zeldaengine_tpu_torch.scene.assets import (  # noqa: E402
    build_scene_from_world)
from zeldaengine_tpu_torch.scene.demo import build_golden_scene  # noqa: E402
from zeldaengine_tpu_torch.tools import gather_probe, walk_stats  # noqa: E402
from zeldaengine_tpu_torch.tools._scenes import (  # noqa: E402
    config3, config4, config4_scene)
from zeldaengine_tpu_torch.utils.image import read_png  # noqa: E402

# The setup's seeded edge cases, shared with the CPU tests.
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from _torch_setup_cases import (  # noqa: E402
    HEIGHT as EDGE_H, WIDTH as EDGE_W, setup_edge_clips, two_sided_modes,
    valid_mask)

# Published peaks of one H100 SXM (NVIDIA data sheet): the roofline the
# kernels' bounds are stated against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations of one (pixel, light) pair of kernel point_lights: the
# light vector (3 sub, 5 for its length, max, sqrt, 3 div), the half vector
# (3 add, 7 for its length, 3 div), three clamped dot products (7 each),
# Fresnel (6), the two visibility roots (5 each), visibility (2), the NDF
# (7), fr (2), fd90 (4), light and view scatter (7 + 3), fd and kd (4),
# falloff (5), radiance (2) and the three channel updates (5 each).
OPS_PER_PIXEL_LIGHT = 115
# fp32 operations of one PCF tap: 2 for the coordinate, floor, subtract and
# clamp, the compare, the select and the add.
OPS_PER_TAP = 8
# fp32 operations of one triangle of kernel triangle_setup (a fused
# multiply-add as 2): pixel coordinates (24), the nine minors (27), the
# determinant (5), orientation and keep (8), the row scale (19), the
# scaled edges, det_scaled, 1/det and zc (19), the bbox (41) and zmin (6);
# the depth bias adds the slope chain (10), its max (3), the bias (2), the
# division (1) and the biased zc (9).
OPS_PER_SETUP = 149
OPS_PER_SETUP_BIAS = 25
SETUP_FIELDS = ("edge", "zc", "valid", "bbox", "zmin")
# Where each kernel's wrapper is called on its path (module, name): the
# argument shim replaces these names while a frame is noted.
FRAME_CALLS = {
    "pair_raster": (frame_graph, "rasterize_pairs"),
    "pair_raster_fused": (frame_graph, "rasterize_pairs_fused"),
    "pcf_taps": (frame_graph, "compute_pcf_vmem"),
    "bilinear_tap": (frame_graph, "sample_base_window"),
    "point_lights": (lighting, "point_lighting"),
    "pcf_window": (frame_graph, "compute_pcf_pallas"),
    "pcf_window_table": (shadow, "build_pcf_window_table"),
    "pcf_window2d_table": (shadow, "build_pcf_window2d_table"),
    "triangle_setup": (frame_graph, "triangle_setup"),
}
# Failures found by a phase whose kernels phase kernels replays first.
FAILURES = []
# Launches of each kernel in one frame of each path. Kernel
# triangle_setup runs once a raster pass (the shadow pass with its depth
# bias); kernel fma computes the vertex transforms' multiply-adds, two
# launches a transform (``_mat4_sum``): positions and normals, the camera's
# clip transform, the shadow clip transform. Config 3's deferred frame:
# 2 setups, 2 + 2 + 2 fma.
MAIN_PATH = {"pair_raster": 1, "pair_raster_fused": 1, "pcf_taps": 1,
             "bilinear_tap": 1, "point_lights": 1, "fma": 6,
             "triangle_setup": 2}
# The config-1 forward frame (no shadow map, no skydome, no point light:
# the forward raster and its PCF) and the golden scene's view 0 (a
# deferred and a forward pass; two point-light slots, below
# point_kernel_min: the plain loop, unless the kernel is asked for).
FORWARD_PATH = {"pair_raster_fused": 1, "pcf_taps": 1, "fma": 4,
                "triangle_setup": 1}
GOLDEN_PATH = {"pair_raster": 1, "pair_raster_fused": 2, "pcf_taps": 2,
               "bilinear_tap": 1, "fma": 6, "triangle_setup": 3}
# Bench config 4 (no point light: K5 never). Kernel fma also runs the two
# meshlet culls' sums (ops/culling.py): 3 for each view-model product and
# 14 for each cull with its cone test (the shadow pass's too:
# shadow_cone_cull): 6 + 34.
FRAME4_PATH = {"pair_raster": 1, "pair_raster_fused": 1, "pcf_taps": 1,
               "bilinear_tap": 1, "fma": 40, "triangle_setup": 2}
# Bench config 5 (the engine's frame of the demo world, deferred only, 16
# point lights culled to 40x128 blocks): K1-K5 once per rendered frame.
CONFIG5_KERNELS = ("pair_raster", "pair_raster_fused", "pcf_taps",
                   "bilinear_tap", "point_lights")
# Phase options (config 3's frame, its scene with a seeded background image
# and the merged environment table): the frames of the remaining frame
# options, each with its launches per frame. The dome mesh adds one K1
# launch (ids, the frame's depth as initial depth), 4 of kernel fma (its
# two vertex transforms) and one of kernel triangle_setup; the background
# rect one K4 launch;
# the merged tap replaces both K4 launches; the ablations drop K3 ("nopcf"),
# K5 ("nolight") and K4 ("nosky").
ABLATE_ALL = ("nopcf pcfcoords pcfbuild nolight nodirect norefl reflgather "
              "noswitch nosky lodprobe notex noattrs")
OPTION_FRAMES = {
    "mesh_skydome_background": (
        dict(skydome_mode="mesh", enable_background=True),
        dict(MAIN_PATH, pair_raster=2, fma=10, triangle_setup=3)),
    "ysort_off": (dict(raster_ysort=False), MAIN_PATH),
    "early_out_aligned": (
        dict(raster_ysort=False, raster_early_out=True, pair_align=True),
        MAIN_PATH),
    "background": (dict(enable_background=True),
                   dict(MAIN_PATH, bilinear_tap=2)),
    "env_merge_background": (dict(env_merge=True, enable_background=True),
                             dict(MAIN_PATH, bilinear_tap=0)),
    "textured_reflection_half": (dict(reflection_half=True), MAIN_PATH),
    "all_ablations": (dict(ablate=ABLATE_ALL),
                      dict(MAIN_PATH, pcf_taps=0, bilinear_tap=0,
                           point_lights=0)),
}
# Phase bands: (case, scene, devices, striped) - config 3's frame striped
# over 4 and 8 bands and contiguous over 4 (270-row bands, which start
# inside a 64-row tile row), and config 5's world contiguous over 4, on one
# card.
BAND_CASES = (("config3_striped_4", "config3", 4, True),
              ("config3_striped_8", "config3", 8, True),
              ("config3_contiguous_4", "config3", 4, False),
              ("config5_contiguous_4", "config5", 4, False))
# Phase rasters: the JAX package's raster values. "pallas" rasterizes the
# GBuffer (and forward) pass through K1 with ids instead of K2, and
# resolves it through the gather path, whose multiply-adds are 31 launches
# of kernel fma a pass (the edge values 1, the quotient rule 2, the corner
# mix 6, the uv footprint 2, its TBN 20: the uv determinant and the tangent
# 1 each, six sums of squares 2 each, n . t 2, the tangent's projection 1,
# the cross product 1, the normal's sum 2); "jnp" rasterizes every pass
# brute force (no K1, no K2) before the same gather path; "fused" is the
# "auto" route.
GATHER_FMA = 31
PALLAS_PATH = dict(MAIN_PATH, pair_raster=2, pair_raster_fused=0,
                   fma=MAIN_PATH["fma"] + GATHER_FMA)
PALLAS_FORWARD_PATH = dict(FORWARD_PATH, pair_raster=1, pair_raster_fused=0,
                           fma=FORWARD_PATH["fma"] + GATHER_FMA)
JNP_PATH = dict(MAIN_PATH, pair_raster=0, pair_raster_fused=0,
                fma=MAIN_PATH["fma"] + GATHER_FMA)
# The PCF backends without a kernel (plain PyTorch on the card), one
# config-3 frame each against the exact filter; all but half_y4 are exact.
PCF_PLAIN_BACKENDS = ("packed_y4", "packed_y8", "packed4", "packed8",
                      "packed16", "window1", "half_y4")
# Scenes built by one phase for another (config 3t's, for phase options).
SCENES = {}
GOLDEN_VIEWS = {"final": 0, "basecolor": 1, "normals": 4, "shadow": 8,
                "gbuffervis": 9}
REPO = os.path.dirname(os.path.abspath(__file__))
# The kernel each opt-in PCF backend adds to the frame (K3 then runs not).
PCF_BACKEND_KERNEL = {
    "pallas": "pcf_window",
    "packed_roll": "pcf_window_table",
    "window_roll": "pcf_window2d_table",
    "half_wr": "pcf_window2d_table",
}

KERNELS = {
    "pair_raster": dict(
        source="zeldaengine_tpu_torch/csrc/pair_raster.cu",
        replaces="zeldaengine_tpu/ops/rasterize_pallas.py:764"),
    "pair_raster_fused": dict(
        source="zeldaengine_tpu_torch/csrc/pair_raster_fused.cu",
        replaces="zeldaengine_tpu/ops/rasterize_pallas.py:1375"),
    "pcf_taps": dict(
        source="zeldaengine_tpu_torch/csrc/pcf_taps.cu",
        replaces="zeldaengine_tpu/ops/pcf_vmem.py:62"),
    "bilinear_tap": dict(
        source="zeldaengine_tpu_torch/csrc/bilinear_tap.cu",
        replaces="zeldaengine_tpu/ops/window_tap.py:48"),
    "point_lights": dict(
        source="zeldaengine_tpu_torch/csrc/point_lights.cu",
        replaces="zeldaengine_tpu/ops/lighting_pallas.py:52"),
    "pcf_window": dict(
        source="zeldaengine_tpu_torch/csrc/pcf_window.cu",
        replaces="zeldaengine_tpu/ops/pcf_pallas.py:37"),
    "pcf_window_table": dict(
        source="zeldaengine_tpu_torch/csrc/pcf_window_table.cu",
        replaces="zeldaengine_tpu/ops/pcf_pallas.py:260"),
    "pcf_window2d_table": dict(
        source="zeldaengine_tpu_torch/csrc/pcf_window_table.cu",
        replaces="zeldaengine_tpu/ops/pcf_pallas.py:311"),
    # No pallas_call: XLA fuses these multiply-adds in the reference's
    # compiled vertex transforms (apply_mat4_point at this line), view
    # matrices and meshlet culls.
    "fma": dict(
        source="zeldaengine_tpu_torch/csrc/fma.cu",
        replaces="zeldaengine_tpu/math/transforms.py:195"),
    # No pallas_call: XLA's fusion of triangle_setup, at this line.
    "triangle_setup": dict(
        source="zeldaengine_tpu_torch/csrc/triangle_setup.cu",
        replaces="zeldaengine_tpu/ops/rasterize.py:51"),
    # The probe tools' kernels (phase probes), on no frame path.
    "gather_probe": dict(
        source="zeldaengine_tpu_torch/csrc/gather_probe.cu",
        replaces="tools/pallas_gather_probe.py:27"),
    "fma_peak": dict(
        source="zeldaengine_tpu_torch/csrc/fma_peak.cu",
        replaces="tools/walk_stats.py:53"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(``fn()``, its device ms by CUDA events): one call, timed and
    kept."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph, the median of three replays over ``reps``. The host's cost of
    each call (Python wrapper, argument checks, allocation) is outside the
    number, which ``cuda_ms`` includes wherever the host enqueues slower
    than the card runs."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def kernel_times(call, reps: int) -> dict:
    """A kernel's times on the card: ``ms`` (also ``kernel_ms``) from
    ``graph_ms``, ``eager_ms`` from ``cuda_ms``."""
    ms = graph_ms(call, reps)
    return dict(ms=ms, kernel_ms=ms, eager_ms=cuda_ms(call, reps))


def golden(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The repo's whole-frame criterion (tests/test_golden.py): fewer than
    1 % of values off by more than 4/255 and median difference <= 1/255."""
    diff = (got - want).abs()
    off = float((diff > 4 / 255).float().mean())
    med = float(diff.median())
    check(off < 0.01 and med <= 1 / 255,
          f"golden criterion failed: {off:.4f} off by > 4/255, median {med}")
    return {"off_fraction": off, "median": med, "max": float(diff.max())}


# ------------------------------------------------------------------ phases


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    smi = card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    info = dict(
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, max_sm_clock_hz=gather_probe.max_sm_clock_hz(),
        sm_count=torch.cuda.get_device_properties(0).multi_processor_count,
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc.strip().splitlines()[-2].strip(), python=sys.version.split()[0])
    emit("device", **info)
    return info


def phase_build() -> None:
    # Always from the sources of this checkout: an earlier build is removed.
    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)
    t0 = time.time()
    lib = _build.build(verbose=True)
    _build.load()
    emit("build", seconds=round(time.time() - t0, 2), library=lib.name,
         sources=[p.name for p in _build.sources()],
         flags=" ".join(_build.NVCC_FLAGS))


@contextlib.contextmanager
def recorded_calls(calls: dict):
    """While active, every call a frame makes to a kernel's wrapper, to
    ``build_pairs`` or to the gather path ``surface_attributes`` is noted in
    ``calls`` (references, not copies) and passed on unchanged:
    ``calls[kernel] = (args, kwargs)`` of the last call without the
    ``backend`` keyword, ``calls["all:" + kernel]`` every call in order,
    ``calls["build_pairs"] = [(setup, pairs), ...]`` in call order (shadow
    pass first, GBuffer second)."""
    saved = []

    def shim(module, name, key):
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def call(*args, **kw):
            out = fn(*args, **kw)
            if key == "build_pairs":
                calls.setdefault(key, []).append((args[0], out))
            else:
                noted = (args, {k: v for k, v in kw.items()
                                if k != "backend"})
                calls[key] = noted
                calls.setdefault("all:" + key, []).append(noted)
            return out
        setattr(module, name, call)

    shim(frame_graph, "build_pairs", "build_pairs")
    shim(frame_graph, "surface_attributes", "surface_attributes")
    for key, (module, name) in FRAME_CALLS.items():
        shim(module, name, key)
    # fma_f32 is called by name from its own module.
    shim(transforms, "fma_f32", "fma")
    try:
        yield calls
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def needed_tests(pairs: rc.PairedTriangles, setup, height, width, tile_h,
                 tile_w, y0_tiles: int = 0):
    """(pixel, pair) tests the function needs on this pair stream, and the
    tests of a walk without skips. A pair can only cover pixels whose centre
    lies inside its triangle's bbox, so for every (tile, pair) of the dense,
    supertile and global ranges only the pixel centres of bbox & tile are
    counted; a walk without skips tests all tile_h * tile_w pixels. In a
    row band (``y0_tiles``) the tiles lie y0_tiles tile rows down."""
    n_ty, n_tx = height // tile_h, width // tile_w
    tile, pair = rc._tile_pair_list(pairs, n_ty, n_tx, tile_h, tile_w)
    bbox = setup.bbox[pairs.pair_tri.long()[pair]]

    def centres(lo, hi, first, size):
        # pixel centres i + 0.5 in [lo, hi], clipped to [first, first+size)
        i0 = torch.maximum(torch.ceil(lo - 0.5), first)
        i1 = torch.minimum(torch.floor(hi - 0.5), first + (size - 1))
        return (i1 - i0 + 1).clamp_min(0)

    nx = centres(bbox[:, 0], bbox[:, 2], (tile % n_tx).float() * tile_w,
                 tile_w)
    ny = centres(bbox[:, 1], bbox[:, 3],
                 (tile // n_tx + y0_tiles).float() * tile_h, tile_h)
    return int((nx * ny).double().sum()), int(tile.numel()) * tile_h * tile_w


def strip_walk_load(pairs, height, width, kw, split: bool = False) -> dict:
    """The tests the strip walk makes (rc.strip_walk_tests: kernels
    pair_raster and pair_raster_fused), and how evenly they fall on the
    warps of a block (the block walks its chunks in step, so a crowded
    strip holds the other warps) and on the tiles. ``split``: also on the
    blocks of kernel pair_raster, which splits a crowded tile's sequence
    (rc.split_parts_of at its default part sizes)."""
    th, tw = kw["tile_h"], kw["tile_w"]
    per = rc.strip_walk_tests(pairs, height, width, th, tw,
                              kw.get("sub_rows", 8), kw.get("y_row", -1),
                              kw.get("y0_tiles", 0))
    per_tile = per.sum(1)
    busy = per[per > 0].double()
    hist = torch.bincount(torch.floor(torch.log2(busy)).long()) \
        if busy.numel() else torch.zeros(0)
    out = dict(
        tests=int(per.sum()),
        # share of warp slots doing tests if each block ran at the pace of
        # its busiest warp (1.0: perfectly even)
        warp_share_at_slowest_pace=float(
            per.sum().double() / (per.amax(1).double().sum() * per.shape[1])),
        tile_tests_max_over_mean=float(
            per_tile.max().double() / per_tile.double().mean()),
        busiest_tile_share=float(per_tile.max().double() / per.sum()),
        warp_tests_log2_histogram=hist.tolist())
    if split:
        tiles, _, hit = rc.strip_walk_hits(pairs, height, width, th, tw,
                                           kw.get("sub_rows", 8),
                                           kw.get("y_row", -1),
                                           kw.get("y0_tiles", 0))
        _, _, part, split_tiles = rc.split_parts_of(pairs, height, width,
                                                    th, tw)
        n_parts = rc.SPLIT_PARTS
        tests = hit.sum(1) * (32 * rc._pixels_per_thread(th, tw))
        blocks = torch.zeros(per_tile.numel() * n_parts, dtype=torch.int64,
                             device=tests.device)
        blocks.index_add_(0, tiles * n_parts + part, tests)
        walking = blocks[blocks > 0].double()
        out.update(
            split_tiles=int(split_tiles.sum()), tiles=int(per_tile.numel()),
            blocks_walking=int(walking.numel()),
            block_tests_max_over_mean=float(walking.max() / walking.mean()),
            busiest_block_share=float(walking.max() / walking.sum()))
    return out


def raster_bound(pairs, setup, height, width, kw, out_words: int,
                 walk: dict, path: str = "frame") -> dict:
    """``walk``: the strip walk's load (``strip_walk_load``); ``path``: the
    frame the pairs came from (the ``bound`` line's label). ``pairs`` as
    ``build_pairs`` returned them: ``pair_tri`` indexes ``setup``'s rows."""
    tests, all_tests = needed_tests(pairs, setup, height, width,
                                    kw["tile_h"], kw["tile_w"],
                                    kw.get("y0_tiles", 0))
    kernel_tests = walk["tests"]
    live = int(pairs.gbounds[1])
    n_bytes = (live * pairs.records.shape[1] * 4 + live * 4
               + (pairs.starts.numel() * 2 + pairs.sstarts.numel() * 2 + 2) * 4
               + height * width * 4 * out_words)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = tests * walk_stats.OPS_PER_TEST / PEAK_FP32_PER_S * 1e3
    extra = dict(pixel_pair_tests_without_skip=all_tests,
                 **{k: v for k, v in walk.items() if k != "tests"})
    emit("bound", path=path, pixel_pair_tests_in_bbox=tests,
         pixel_pair_tests_of_the_kernel=kernel_tests,
         kernel_over_bbox=kernel_tests / max(tests, 1), live_pairs=live,
         bytes=n_bytes, bytes_ms=t_bytes, operations_ms=t_ops, **extra)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def one_block_a_tile():
    """Kernel pair_raster without its split of crowded tiles: every tile's
    sequence walked by one block."""
    saved = rc.SPLIT_PARTS
    rc.SPLIT_PARTS = 1
    try:
        yield
    finally:
        rc.SPLIT_PARTS = saved


def bytes_bound(n_bytes: int) -> dict:
    return dict(bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")


def ops_bound(n_bytes: int, n_ops: int) -> dict:
    """The larger of bytes over the memory rate and fp32 operations (an
    FMA as two) over the fp32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def cmp_setup(k, p) -> dict:
    """Kernel triangle_setup against its plain version on all five fields:
    floats as int32 bits (a zero's sign counts; two NaNs are equal, as
    in the CPU tests), the valid mask as booleans."""
    err = 0.0
    for name in SETUP_FIELDS:
        a, b = getattr(k, name), getattr(p, name)
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"triangle_setup {name}: {a.dtype}{tuple(a.shape)} against "
              f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.bool:
            same = a == b
        else:
            same = (a.view(torch.int32) == b.view(torch.int32)) | (
                a.isnan() & b.isnan())
            err = max(err, float(torch.nan_to_num((a - b).abs(), nan=0.0)
                                 .max()) if a.numel() else 0.0)
        bad = int((~same).sum())
        check(bad == 0, f"triangle_setup {name}: {bad} values differ "
              f"(max-abs {err})")
    return {"max_abs_err": err, "valid": int(k.valid.sum())}


def setup_replays(calls) -> dict:
    """Every noted triangle_setup call through the kernel and the plain
    version, compared by ``cmp_setup``."""
    errs = [cmp_setup(rast.triangle_setup(*a, backend="cuda", **kw),
                      rast.triangle_setup(*a, backend="torch", **kw))
            ["max_abs_err"] for a, kw in calls]
    return {"calls": len(calls), "max_abs_err": max(errs, default=0.0)}


def setup_bound(args, kw) -> dict:
    """Bytes (the clip rows and masks read once, the five fields written
    once) and operations of one triangle_setup call, and the larger of
    the two times."""
    n = args[0].shape[0]
    masks = sum(m.numel() for m in (kw.get("two_sided"),
                                    kw.get("valid_mask"))
                if isinstance(m, torch.Tensor))
    n_bytes = args[0].numel() * 4 + masks + n * (36 + 12 + 1 + 16 + 4)
    n_ops = n * (OPS_PER_SETUP + (OPS_PER_SETUP_BIAS
                                  if kw.get("depth_bias") else 0))
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return dict(triangles=n, bytes=n_bytes, operations=n_ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def compare_raster(kernel_out, plain_out, fused: bool) -> dict:
    """Depth max-abs <= 1e-6 and the same bits, the sign of a zero
    included; triangle ids equal - both walk pairs in the same order with
    the same arithmetic (-fmad=false), so the mismatch count must be 0;
    fused planes atol/rtol 1e-5 on covered pixels."""
    if not isinstance(kernel_out, tuple):
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    kd, pd = kernel_out[0], plain_out[0]
    err = float((kd - pd).abs().max())
    check(err <= 1e-6, f"depth max-abs {err} > 1e-6")
    bits = int((kd.view(torch.int32) != pd.view(torch.int32)).sum())
    check(bits == 0, f"{bits} depths differ in their bits")
    out = {"max_abs_err": err, "depth_bit_mismatches": bits,
           "negative_zero_depths": int(
               (pd.view(torch.int32) == -2 ** 31).sum())}
    if len(kernel_out) > 1:
        mism = int((kernel_out[1] != plain_out[1]).sum())
        check(mism == 0, f"{mism} triangle ids differ")
        out["id_mismatches"] = mism
    if fused:
        cov = plain_out[1] >= 0
        k, p = kernel_out[2][:, cov], plain_out[2][:, cov]
        perr = (k - p).abs()
        bad = int((perr > 1e-5 + 1e-5 * p.abs()).sum())
        check(bad == 0, f"{bad} plane values beyond atol/rtol 1e-5")
        unc = (kernel_out[2][:, ~cov] - plain_out[2][:, ~cov]).abs()
        check(unc.numel() == 0 or float(unc.max()) == 0.0,
              "uncovered planes differ")
        out["planes_max_abs_err"] = float(perr.max()) if perr.numel() else 0.0
        out["max_abs_err"] = max(err, out["planes_max_abs_err"])
    return out


def random_pairs(seed, n, height, width, tile_h, tile_w, extra_w=0,
                 **pair_kw):
    """A seeded pair stream of random clip-space triangles (some big, some
    behind the camera) - the small ragged case."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.0, 1.0, (n, 1, 3)).astype(np.float32)
    pos = centers + rng.uniform(-0.15, 0.15, (n, 3, 3)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, (n, 3, 1)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (n, 1, 1)).astype(np.float32) * w
    clip = np.concatenate([pos[..., :2] * w, z * np.ones((1, 3, 1)), w], -1)
    clip[:4, :, :2] *= 6.0
    clip[4, :, 3] = -1.0
    setup = rast.triangle_setup(
        torch.from_numpy(clip.astype(np.float32)).cuda(), width, height,
        two_sided=True)
    extra = None
    if extra_w:
        extra = torch.from_numpy(
            rng.random((n, extra_w)).astype(np.float32)).cuda()
    return rc.build_pairs(setup, width, height, tile_h, tile_w, extra=extra,
                          **pair_kw)


def crowded_pairs(seed=11, n=3000, dim=256, tile=(64, 32), y0_tiles=0,
                  rows=None):
    """A pair stream whose tiles are crowded: ``n`` small triangles (a few
    texels wide, depths in (0.1, 0.9), some coincident) over one 64x32
    tile of a ``dim``^2 map (its tile row 1), plus a sparse background,
    binned as the shadow map bins (z sort, 8-row strips); with ``y0_tiles``
    / ``rows``, binned for the row band of ``rows`` map rows from tile row
    ``y0_tiles``."""
    rng = np.random.default_rng(seed)
    th, tw = tile
    x0, y0 = 96.0, 64.0  # the crowded tile's corner, in texels
    cx = rng.uniform(x0, x0 + tw, (n, 1))
    cy = rng.uniform(y0, y0 + th, (n, 1))
    bg = rng.uniform(0.0, dim, (n // 4, 2))
    cx = np.concatenate([cx, bg[:, :1]])
    cy = np.concatenate([cy, bg[:, 1:]])
    m = cx.shape[0]
    px = cx + rng.uniform(-4.0, 4.0, (m, 3))
    py = cy + rng.uniform(-4.0, 4.0, (m, 3))
    z = np.repeat(rng.uniform(0.1, 0.9, (m, 1)), 3, 1)
    z[1::7] = z[0:-1:7]  # exact depth ties between neighbours
    px[1::7], py[1::7] = px[0:-1:7], py[0:-1:7]
    clip = np.stack([px / dim * 2.0 - 1.0, py / dim * 2.0 - 1.0, z,
                     np.ones_like(z)], -1).astype(np.float32)
    setup = rast.triangle_setup(torch.from_numpy(clip).cuda(), dim, dim,
                                two_sided=True)
    return rc.build_pairs(setup, dim, dim if rows is None else rows, th, tw,
                          sort_z=True, ysort_sub_rows=8, expand=8,
                          y0_tiles=y0_tiles)


# Kernel pcf_taps's blocks of pixels (kBlockX x kBlockY) and the texels of
# their shared-memory windows (kWin), csrc/pcf_taps.cu.
PCF_BLOCK = (16, 32)
PCF_WINDOW = 4096


def pcf_window_blocks(sc, dims, radius, scale) -> dict:
    """How kernel pcf_taps serves the blocks of this coordinate field: the
    texel box each 32x16 block's in-range taps reach (the kernel's
    arithmetic), and the share of blocks whose box fits its 4,096-texel
    shared-memory window (the others tap the map directly)."""
    h, w = sc.shape[:2]
    wq = sc[..., 3:4]
    s = sc / torch.where(wq.abs() > 1e-20, wq, torch.ones_like(wq))
    live = (s[..., 2] > -1.0) & (s[..., 2] < 1.0) & (s[..., 3] > 0.0)
    ends = torch.tensor([-radius, radius], dtype=torch.float32,
                        device=sc.device)
    bh, bw = PCF_BLOCK
    ph, pw = -(-h // bh) * bh, -(-w // bw) * bw
    big = 2 ** 40
    area = None
    for axis, dim in ((0, dims[1]), (1, dims[0])):
        i = torch.floor(s[..., axis, None] * float(dim) + scale * ends).to(
            torch.int32).to(torch.int64)
        lo = torch.where(live, i.amin(-1), torch.full_like(i[..., 0], big))
        hi = torch.where(live, i.amax(-1), torch.full_like(i[..., 0], -big))
        lo = torch.nn.functional.pad(lo, (0, pw - w, 0, ph - h), value=big)
        hi = torch.nn.functional.pad(hi, (0, pw - w, 0, ph - h), value=-big)
        lo = lo.reshape(ph // bh, bh, pw // bw, bw).amin((1, 3))
        hi = hi.reshape(ph // bh, bh, pw // bw, bw).amax((1, 3))
        ext = (hi - lo + 1).clamp(0, 1 << 20)
        area = ext if area is None else area * ext
    tapping = area > 0
    return dict(window_blocks_share=float(
        ((area <= PCF_WINDOW) & tapping).sum() / tapping.sum().clamp_min(1)),
        window_texels_median=float(area[tapping].double().median()))


def cmp_pcf(k, p):
    """Bit for bit: the same arithmetic in the same order (-fmad=false,
    IEEE divisions); with window origins, equal integers."""
    (k, ko), (p, po) = k, p
    err = float((k - p).abs().max())
    check(torch.equal(k, p), f"max-abs {err}: factors differ")
    check(torch.equal(ko, po),
          f"{int((ko != po).any(-1).sum())} window origins differ")
    return {"max_abs_err": err, "tiles": ko.shape[0] * ko.shape[1],
            "shadowed_fraction": float((k != 1.0).float().mean())}


def pcf_window_cases(run, sm, sc, kw, label) -> dict:
    """Kernel pcf_window against its plain version, origins included."""
    return run("pcf_window", label, pcf_window.compute_pcf_pallas, (sm, sc),
        dict(kw, return_origins=True), cmp_pcf)


def pcf_window_extra_cases(rng) -> dict:
    """The K6 cases beyond the frame's, on maps of uniform random depths
    (so that a tap read from the wrong texel shows): wild coordinates on a
    256^2 map (windows of 128 and 256), a 64^2 map (the 128-column pad is
    wider than the map), a 200^2 map, a tile with no valid pixel, coordinates of +-1e3
    and +-1e9 map widths, |w| <= 1e-20 and negative w, tiles whose tap box
    exceeds the shared-memory stage, staged windows that wrap, radius 3
    (the run-time-radius taps), and 16x32 tiles on a ragged 40x200
    frame."""
    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    def coords(h, w, uv, z=(-0.2, 1.1), wq=(0.5, 1.5)):
        return np.concatenate(
            [rng.uniform(*uv, (h, w, 2)), rng.uniform(*z, (h, w, 1)),
             rng.uniform(*wq, (h, w, 1))], -1)

    base = dict(radius=2, scale=1.5, bias=0.002, tile_h=32, tile_w=128)
    sm256 = cuda(rng.random((256, 256)))
    sm1k = cuda(rng.random((1024, 1024)))
    wild = coords(64, 256, (-0.3, 1.3))
    valid = rng.random((64, 256)) < 0.8
    valid[:32, :128] = False  # tile (0, 0) weighs nothing: the plain mean
    valid_t = torch.from_numpy(valid).cuda()
    cases = {}
    for win in (128, 256):
        cases[f"wild 64x256, map 256, win {win}"] = (
            sm256, cuda(wild), dict(base, win=win))
    cases["wild 64x256, map 256, tile (0, 0) with no valid pixel"] = (
        sm256, cuda(wild), dict(base, win=128, valid=valid_t))
    cases["map 64 (the 128-column pad is wider than the map)"] = (
        cuda(rng.random((64, 64))), cuda(coords(64, 256, (-1.5, 2.5))),
        dict(base, win=256))
    cases["map 200 (not a power of two: fmod wraps)"] = (
        cuda(rng.random((200, 200))), cuda(coords(64, 256, (-1.5, 2.5))),
        dict(base, win=128))
    for far in (1e3, 1e9):
        cases[f"map 1024, coordinates of +-{far:g} map widths"] = (
            sm1k, cuda(coords(64, 256, (-far, far), z=(0.0, 1.0))),
            dict(base, win=256))
    odd_w = coords(64, 256, (0.0, 1.0), z=(0.0, 1.0))
    odd_w[::3, :, 3] = rng.uniform(-1e-20, 1e-20, (22, 256))
    odd_w[1::3, :, 3] = -rng.uniform(0.5, 1.5, (21, 256))
    cases["|w| <= 1e-20 and negative w"] = (sm1k, cuda(odd_w),
                                          dict(base, win=256))
    # Every pixel of a tile far from its neighbours: boxes of ~256^2
    # texels, beyond the 8192-texel stage.
    spread = coords(64, 256, (0.0, 1.0), z=(0.0, 1.0))
    cases["tap boxes beyond the shared-memory stage"] = (
        sm1k, cuda(spread), dict(base, win=256))
    # Smooth coordinates at the map's first texels: small staged boxes
    # whose windows wrap to the map's last texels (on the 64^2 map, the
    # window is the map and wraps anywhere).
    yy, xx = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    smooth = np.stack([1.001 + 0.0002 * xx + 0.00005 * yy,
                       2.002 + 0.0003 * yy + 0.0001 * xx,
                       rng.uniform(0.2, 0.8, (64, 256)),
                       np.ones((64, 256))], -1)
    cases["map 1024, smooth coordinates at its first texels"] = (
        sm1k, cuda(smooth), dict(base, win=256))
    cases["map 64, smooth coordinates"] = (
        cuda(rng.random((64, 64))), cuda(smooth), dict(base, win=256))
    cases["radius 3, scale 1.25 (run-time radius)"] = (
        sm256, cuda(wild), dict(base, radius=3, scale=1.25, win=128))
    cases["ragged 40x200, tiles 16x32"] = (
        sm256, cuda(coords(40, 200, (-0.3, 1.3))),
        dict(base, tile_h=16, tile_w=32, win=128))
    return cases


@contextlib.contextmanager
def staged_texels(n: int):
    """Kernel pcf_window with a stage of at most ``n`` texels (0: every
    tile taps the map directly)."""
    saved = pcf_window.STAGE_TEXELS
    pcf_window.STAGE_TEXELS = n
    try:
        yield
    finally:
        pcf_window.STAGE_TEXELS = saved


def pcf_window_stage(inp, radius, scale, tile_h, tile_w) -> dict:
    """How kernel pcf_window serves the tiles of this frame: the box of
    clamped window indices each tile's in-range taps reach (the kernel's
    arithmetic), and the share of tapping tiles whose box fits the
    8,192-texel stage."""
    geo = inp.geo
    offs = pcf_window.tap_offsets(radius, scale)
    org = inp.origins.repeat_interleave(tile_h, 0).repeat_interleave(
        tile_w, 1).long()
    area = None
    n_ty, n_tx = inp.origins.shape[:2]
    for f, o in ((inp.fy, org[..., 0]), (inp.fx, org[..., 1])):
        lo = torch.clamp(torch.floor(f + offs[0]).long() - o, 0, geo.win - 1)
        hi = torch.clamp(torch.floor(f + offs[-1]).long() - o, 0,
                         geo.win - 1)
        big = 1 << 40
        lo = torch.where(inp.inrange, lo, torch.full_like(lo, big))
        hi = torch.where(inp.inrange, hi, torch.full_like(hi, -big))
        lo = lo.reshape(n_ty, tile_h, n_tx, tile_w).amin((1, 3))
        hi = hi.reshape(n_ty, tile_h, n_tx, tile_w).amax((1, 3))
        ext = (hi - lo + 1).clamp_min(0)
        area = ext if area is None else area * ext
    tapping = area > 0
    return dict(
        stage_tiles_share=float(((area <= pcf_window.STAGE_TEXELS)
                                 & tapping).sum() / tapping.sum().clamp_min(1)),
        box_texels_median=float(area[tapping].double().median()),
        tapping_tiles=int(tapping.sum()))


def device_launches(fn) -> int:
    """Device operations (kernels, copies, sets) one call of ``fn`` runs,
    counted in a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def phase_kernels(captured: dict, frame_launches: dict, paths: dict,
                  path_launches: dict) -> list:
    """Replay every kernel on the inputs a 1080p frame of its path gave it
    (plus option variants and one small ragged shape), hold it against its
    plain version on the card, time both. ``frame_launches[name]`` is the
    kernel's launch count in its path's run. ``paths[path][name]`` are the
    arguments the later slices' frames (config 3t, config 1, the golden
    scene) gave each kernel, replayed bit for bit too;
    ``path_launches[path]`` the launches per frame of each path."""
    rows = []
    checks = {}

    def run(name, label, wrapper, args, kw, compare):
        k = wrapper(*args, backend="cuda", **kw)
        p = wrapper(*args, backend="torch", **kw)
        torch.cuda.synchronize()
        res = compare(k, p)
        checks.setdefault(name, []).append({"case": label, **res})
        return res

    def replay(name, wrapper, compare, cases):
        """The frames of the paths: (path, what) each, each case with its
        device time on those inputs (``graph_ms``)."""
        for path, what in cases:
            check(name in paths[path], f"{path}: {name} was not called")
            args, kw = paths[path][name]
            run(name, f"{path}: {what}", wrapper, args, kw, compare)
            checks[name][-1]["ms"] = graph_ms(
                lambda: wrapper(*args, backend="cuda", **kw), 10)

    def cmp_bits(k, p):
        k, p = (k[0], p[0]) if isinstance(k, tuple) else (k, p)
        err = float((k - p).abs().max())
        check(torch.equal(k, p), f"not bit for bit (max-abs {err})")
        return {"max_abs_err": err}

    def by_path(name):
        return {path: c.get(name, 0) for path, c in path_launches.items()}

    def frame4_times(name, wrapper, pass_index, out_words):
        """The raster kernel's device time and bound on config 4's frame
        (the pass's pairs as build_pairs gave them, before their ids were
        mapped back through the compaction)."""
        args, kw = paths["frame4"][name]
        call = lambda: wrapper(*args, backend="cuda", **kw)  # noqa: E731
        setup, built = paths["frame4"]["build_pairs"][pass_index]
        check(built.records is args[0].records,
              f"frame4: {name}'s pairs are not build_pairs' pass "
              f"{pass_index}")
        return dict(ms=graph_ms(call, 10), **raster_bound(
            built, setup, args[1], args[2], kw, out_words,
            walk=strip_walk_load(built, args[1], args[2], kw),
            path="frame4"))

    # ---- K1 pair_raster
    (pairs, ph, pw), kw = captured["pair_raster"]
    (setup_sh, pairs_sh), (setup_gb, pairs_gb) = captured["build_pairs"]
    check(pairs_sh is pairs, "shadow pairs are not the first build_pairs call")
    check(kw["y_row"] >= 0, "the frame's shadow pairs carry no strip span")
    cmp_k1 = lambda k, p: compare_raster(k, p, False)  # noqa: E731
    main = run("pair_raster", "frame: shadow map, strip span, depth_only",
               rc.rasterize_pairs, (pairs, ph, pw), kw, cmp_k1)
    kw_ids = dict(kw, depth_only=False)
    run("pair_raster", "shadow pairs, strip span, with ids",
        rc.rasterize_pairs, (pairs, ph, pw), kw_ids, cmp_k1)
    init = torch.from_numpy(np.random.default_rng(1).uniform(
        0.9, 1.0, (ph, pw)).astype(np.float32)).cuda()
    for depth_only in (True, False):
        run("pair_raster", f"shadow pairs, init_depth, depth_only={depth_only}",
            rc.rasterize_pairs, (pairs, ph, pw, init),
            dict(kw, depth_only=depth_only), cmp_k1)
    with one_block_a_tile():
        run("pair_raster", "shadow pairs, strip span, one block a tile",
            rc.rasterize_pairs, (pairs, ph, pw), kw, cmp_k1)
    small = random_pairs(3, 400, 72, 96, 24, 32, sort_z=True,
                         ysort_sub_rows=8, expand=2)
    for y_row in (13, -1):
        run("pair_raster", f"ragged 72x96, tiles 24x32, y_row={y_row}",
            rc.rasterize_pairs, (small, 72, 96),
            dict(tile_h=24, tile_w=32, sub_rows=8, y_row=y_row), cmp_k1)
    # A crowded tile split over several blocks, merged by atomicMin.
    crowd = crowded_pairs()
    crowd_kw = dict(tile_h=64, tile_w=32, sub_rows=8, y_row=13)
    split_tiles = rc.split_parts_of(crowd, 256, 256, 64, 32)[3]
    check(bool(split_tiles.any()), "the crowded stream splits no tile")
    crowd_init = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.0, (256, 256)).astype(np.float32)).cuda()
    for depth_only in (True, False):
        for cinit in (None, crowd_init):
            run("pair_raster",
                f"crowded 256x256 ({int(split_tiles.sum())} tiles split), "
                f"depth_only={depth_only}, init_depth={cinit is not None}",
                rc.rasterize_pairs, (crowd, 256, 256, cinit),
                dict(crowd_kw, depth_only=depth_only), cmp_k1)
    # Signed zeros on split tiles: the crowded stream's coincident pairs
    # (triangle 7k + 1 repeats 7k) get depth planes of -0.0 / +0.0 and, for
    # k odd, +0.0 / -0.0; the earlier pair's zero must win with its sign.
    tri = crowd.pair_tri.long()
    k7, r7 = tri // 7, tri % 7
    zeros = crowd.records.clone()
    first = (r7 == 0) & (k7 % 2 == 0) | (r7 == 1) & (k7 % 2 == 1)
    zeros[first, 9:12] = -0.0
    zeros[(r7 < 2) & ~first, 9:12] = 0.0
    signed = crowd._replace(records=zeros)
    for depth_only in (True, False):
        res = run("pair_raster", "crowded 256x256, coincident pairs of depth "
                  f"-0.0 / +0.0, depth_only={depth_only}", rc.rasterize_pairs,
                  (signed, 256, 256), dict(crowd_kw, depth_only=depth_only),
                  cmp_k1)
        check(res["negative_zero_depths"] > 0, "no -0.0 depth won")
    replay("pair_raster", rc.rasterize_pairs, cmp_k1,
           [("frame3t", "shadow map"), ("golden", "shadow map, 8x128 tiles"),
            ("frame4", "shadow map 512^2, 32x128 tiles, compacted casters"),
            ("config5", "shadow map 512^2, 32x128 tiles, engine tick")])
    call = lambda: rc.rasterize_pairs(  # noqa: E731
        pairs, ph, pw, backend="cuda", **kw)
    times = kernel_times(call, 10)
    crowd_call = lambda: rc.rasterize_pairs(  # noqa: E731
        crowd, 256, 256, backend="cuda", depth_only=True, **crowd_kw)
    crowd_ms = graph_ms(crowd_call, 10)
    # The strip walk alone, timed in this call.
    with one_block_a_tile():
        one_ms = graph_ms(call, 10)
        crowd_one_ms = graph_ms(crowd_call, 10)
    plain_ms = cuda_ms(lambda: rc.rasterize_pairs(
        pairs, ph, pw, backend="torch", **kw), 1)
    rows.append(dict(name="pair_raster", route="cuda",
                     **KERNELS["pair_raster"],
                     launches=frame_launches["pair_raster"],
                     launches_per_frame_by_path=by_path("pair_raster"),
                     max_abs_err=main["max_abs_err"], **times,
                     plain_ms=plain_ms,
                     ms_one_block_a_tile=one_ms, crowded_ms=crowd_ms,
                     crowded_ms_one_block_a_tile=crowd_one_ms,
                     **raster_bound(pairs, setup_sh, ph, pw, kw, out_words=1,
                                    walk=strip_walk_load(pairs, ph, pw, kw,
                                                         split=True)),
                     frame4=frame4_times("pair_raster", rc.rasterize_pairs,
                                         0, 1),
                     # No PyTorch call rasterizes pair lists.
                     library_ms=None))

    # ---- K2 pair_raster_fused
    (fpairs, fh, fw), fkw = captured["pair_raster_fused"]
    check(pairs_gb is fpairs, "GBuffer pairs are not the second build_pairs call")
    cmp_fused = lambda k, p: compare_raster(k, p, True)  # noqa: E731
    check(fkw["y_row"] >= 0, "the frame's GBuffer pairs carry no strip span")
    fmain = run("pair_raster_fused", "frame: GBuffer, strip span",
                rc.rasterize_pairs_fused, (fpairs, fh, fw), fkw, cmp_fused)
    finit = torch.from_numpy(np.random.default_rng(2).uniform(
        0.9, 1.0, (fh, fw)).astype(np.float32)).cuda()
    run("pair_raster_fused", "frame: GBuffer, strip span, init_depth",
        rc.rasterize_pairs_fused, (fpairs, fh, fw),
        dict(fkw, init_depth=finit), cmp_fused)
    for need_uv in (True, False):
        for has_combo in (True, False):
            extra_w = rc.fused_extra_width(need_uv, has_combo)
            sp = random_pairs(5, 400, 72, 96, 24, 32, sort_z=True,
                              ysort_sub_rows=8, extra_w=extra_w)
            # The span column follows the payload and the z column.
            spans = (12 + extra_w + 1, -1) if need_uv and has_combo \
                else (12 + extra_w + 1,)
            for y_row in spans:
                run("pair_raster_fused",
                    f"ragged 72x96, tiles 24x32, need_uv={need_uv}, "
                    f"has_combo={has_combo}, y_row={y_row}",
                    rc.rasterize_pairs_fused, (sp, 72, 96),
                    dict(tile_h=24, tile_w=32, sub_rows=8, y_row=y_row,
                         texture_size=64, need_uv=need_uv,
                         has_combo=has_combo, combo_const=3.0), cmp_fused)
    # Tiles wider than a warp: a lane's pixels lie in two columns.
    extra_w = rc.fused_extra_width()
    wide = random_pairs(6, 400, 72, 128, 24, 64, sort_z=True,
                        ysort_sub_rows=8, extra_w=extra_w)
    run("pair_raster_fused", "ragged 72x128, tiles 24x64, strip span",
        rc.rasterize_pairs_fused, (wide, 72, 128),
        dict(tile_h=24, tile_w=64, sub_rows=8, y_row=12 + extra_w + 1,
             texture_size=64), cmp_fused)
    for path in ("forward", "golden"):
        check(paths[path]["pair_raster_fused"][1].get("init_depth")
              is not None, f"{path}: the forward raster has no init_depth")
    replay("pair_raster_fused", rc.rasterize_pairs_fused, cmp_fused,
           [("frame3t", "GBuffer, textured"),
            ("forward", "forward sphere, init_depth = far plane, 32x128 "
             "tiles"),
            ("golden", "forward sphere, init_depth = GBuffer depth"),
            ("frame4", "GBuffer 1024^2, 32x128 tiles, compacted"),
            ("config5", "GBuffer 512^2, 32x128 tiles, engine tick")])
    call = lambda: rc.rasterize_pairs_fused(  # noqa: E731
        fpairs, fh, fw, backend="cuda", **fkw)
    times = kernel_times(call, 10)
    plain_ms = cuda_ms(lambda: rc.rasterize_pairs_fused(
        fpairs, fh, fw, backend="torch", **fkw), 1)
    rows.append(dict(name="pair_raster_fused", route="cuda",
                     **KERNELS["pair_raster_fused"],
                     launches=frame_launches["pair_raster_fused"],
                     launches_per_frame_by_path=by_path("pair_raster_fused"),
                     max_abs_err=fmain["max_abs_err"], **times,
                     plain_ms=plain_ms,
                     **raster_bound(fpairs, setup_gb, fh, fw, fkw,
                                    out_words=2 + rc.ATTR_CH,
                                    walk=strip_walk_load(fpairs, fh, fw,
                                                         fkw)),
                     frame4=frame4_times("pair_raster_fused",
                                         rc.rasterize_pairs_fused, 1,
                                         2 + rc.ATTR_CH),
                     # No PyTorch call rasterizes pair lists.
                     library_ms=None))

    # ---- K3 pcf_taps (max-abs <= 2e-7: one ulp of the averaged factor)
    def cmp_small(k, p):
        err = float((k[0] - p[0]).abs().max())
        check(err <= 2e-7, f"max-abs {err} > 2e-7")
        return {"max_abs_err": err}

    (sm, sc), pkw = captured["pcf_taps"]
    pmain = run("pcf_taps", "frame: deferred resolve",
                pcf_cuda.compute_pcf_vmem, (sm, sc), pkw, cmp_small)
    rng = np.random.default_rng(7)

    def coords(h, w, uv, z=(-0.2, 1.2), wq=(-0.5, 2.0)):
        return torch.from_numpy(np.concatenate(
            [rng.uniform(*uv, (h, w, 2)), rng.uniform(*z, (h, w, 1)),
             rng.uniform(*wq, (h, w, 1))], -1).astype(np.float32)).cuda()

    wild = coords(37, 53, (-1.5, 2.5))
    sm_small = torch.from_numpy(
        rng.random((96, 160)).astype(np.float32)).cuda()
    # The frame's radius 2 takes the window kernel; other radii the direct
    # taps with a run-time radius.
    for radius in (1, 3, 0, 4):
        run("pcf_taps", f"ragged 37x53, wrap + out of range, radius {radius}",
            pcf_cuda.compute_pcf_vmem, (sm_small, wild),
            dict(radius=radius, scale=1.5, bias=0.01), cmp_small)
    tiny = torch.from_numpy(rng.random((5, 5)).astype(np.float32)).cuda()
    for radius, scale in ((2, 1.5), (3, 2.5)):
        run("pcf_taps", f"5x5 map (the footprint wraps twice), radius "
            f"{radius}, scale {scale}", pcf_cuda.compute_pcf_vmem,
            (tiny, wild), dict(radius=radius, scale=scale, bias=0.0),
            cmp_small)
    far = coords(64, 96, (-1e3, 1e3), z=(0.0, 1.0), wq=(0.5, 2.0))
    run("pcf_taps", "frame's map, coordinates of +-1e3 map widths",
        pcf_cuda.compute_pcf_vmem, (sm, far), pkw, cmp_small)
    huge = coords(64, 96, (-1e9, 1e9), z=(0.0, 1.0), wq=(0.5, 2.0))
    run("pcf_taps", "frame's map, coordinates of +-1e9 (int32 saturates)",
        pcf_cuda.compute_pcf_vmem, (sm, huge), pkw, cmp_small)
    # Smooth coordinates: the block windows wrap across the map's edges,
    # and on a 5x5 map they are wider than the map.
    yy, xx = np.meshgrid(np.arange(40), np.arange(96), indexing="ij")
    smooth = torch.from_numpy(np.stack([
        0.985 + 0.0004 * xx + 0.00005 * yy, 0.99 + 0.0003 * yy + 0.0001 * xx,
        0.2 + 0.6 * rng.random((40, 96)), np.ones((40, 96))],
        -1).astype(np.float32)).cuda()
    run("pcf_taps", "frame's map, smooth coordinates across its edges",
        pcf_cuda.compute_pcf_vmem, (sm, smooth), pkw, cmp_small)
    run("pcf_taps", "5x5 map, smooth coordinates (window wider than the map)",
        pcf_cuda.compute_pcf_vmem, (tiny, smooth * 4.0), pkw, cmp_small)
    # The kernel's first block of pixels all out of range: its box is empty.
    bh, bw = PCF_BLOCK
    edge = coords(2 * bh, 2 * bw, (0.0, 1.0), z=(0.0, 1.0), wq=(0.5, 2.0))
    edge[:bh, :bw, 2] = 2.0 * edge[:bh, :bw, 3]
    out_blk = pcf_cuda.compute_pcf_vmem(sm, edge, backend="cuda", **pkw)[0]
    check(bool((out_blk[:bh, :bw] == 1.0).all()),
          "an out-of-range block does not read 1.0")
    run("pcf_taps", f"{2 * bh}x{2 * bw} with an all-out-of-range {bw}x{bh} "
        "block", pcf_cuda.compute_pcf_vmem, (sm, edge), pkw, cmp_small)
    replay("pcf_taps", pcf_cuda.compute_pcf_vmem, cmp_bits,
           [("frame3t", "deferred resolve"),
            ("forward", "forward pixels, shadow map of ones"),
            ("golden", "forward pixels"),
            ("frame4", "deferred resolve 1024^2, 512^2 map"),
            ("config5", "deferred resolve 512^2, 512^2 map")])
    call = lambda: pcf_cuda.compute_pcf_vmem(  # noqa: E731
        sm, sc, backend="cuda", **pkw)
    times = kernel_times(call, 20)
    plain_ms = cuda_ms(lambda: pcf_cuda.compute_pcf_vmem(
        sm, sc, backend="torch", **pkw), 3)
    n_px = sc.shape[0] * sc.shape[1]
    rows.append(dict(name="pcf_taps", route="cuda", **KERNELS["pcf_taps"],
                     launches=frame_launches["pcf_taps"],
                     launches_per_frame_by_path=by_path("pcf_taps"),
                     max_abs_err=pmain["max_abs_err"], **times,
                     plain_ms=plain_ms,
                     **pcf_window_blocks(sc, sm.shape, pkw["radius"],
                                         pkw["scale"]),
                     **bytes_bound(n_px * 20 + sm.numel() * 4),
                     # No PyTorch call compares 25 wrapped taps against a
                     # per-pixel depth.
                     library_ms=None))

    # ---- K4 bilinear_tap
    targs, _ = captured["bilinear_tap"]
    tmain = run("bilinear_tap", "frame: skydome", window_tap.sample_base_window,
                targs, {}, cmp_small)
    planes_s = torch.from_numpy(rng.random((3, 64, 64)).astype(np.float32)).cuda()
    uv_s = torch.from_numpy(
        rng.uniform(-1.0, 2.0, (37, 53, 2)).astype(np.float32)).cuda()
    act_s = torch.from_numpy(rng.random((37, 53)) < 0.7).cuda()
    run("bilinear_tap", "ragged 37x53, 3 channels, wrap seam, mask",
        window_tap.sample_base_window, (planes_s, uv_s, act_s, 64), {},
        cmp_small)
    run("bilinear_tap", "ragged 37x53, no mask",
        window_tap.sample_base_window, (planes_s, uv_s, None, 64), {},
        cmp_small)
    replay("bilinear_tap", window_tap.sample_base_window, cmp_bits,
           [("frame3t", "skydome"), ("golden", "skydome"),
            ("frame4", "skydome 1024^2"), ("config5", "skydome 512^2")])
    call = lambda: window_tap.sample_base_window(  # noqa: E731
        *targs, backend="cuda")
    times = kernel_times(call, 20)
    plain_ms = cuda_ms(lambda: window_tap.sample_base_window(
        *targs, backend="torch"), 3)
    planes, uv = targs[0], targs[1]
    n_px = uv.shape[0] * uv.shape[1]
    rows.append(dict(name="bilinear_tap", route="cuda",
                     **KERNELS["bilinear_tap"],
                     launches=frame_launches["bilinear_tap"],
                     launches_per_frame_by_path=by_path("bilinear_tap"),
                     max_abs_err=tmain["max_abs_err"], **times,
                     plain_ms=plain_ms,
                     **bytes_bound(n_px * (8 + 1 + 4 * planes.shape[0])
                                   + planes.numel() * 4),
                     # F.grid_sample is not the same addressing (it
                     # reflects or clamps where this repeats, then clamps
                     # at the edge): no library call computes this.
                     library_ms=None))
    # ---- K5 point_lights: bit for bit with its plain version is the aim
    # (same operation order, -fmad=false, IEEE div / sqrt); <= 1e-6.
    def cmp_lights(k, p):
        err = float((k - p).abs().max())
        check(err <= 1e-6, f"max-abs {err} > 1e-6")
        return {"max_abs_err": err,
                "values_not_bitwise_equal": int((k != p).sum())}

    largs, lkw = captured["point_lights"]
    lmain = run("point_lights", "frame: 16 lights, blocks 40x128",
                lighting_cuda.point_lighting, largs, lkw, cmp_lights)
    largs512, lkw512 = captured["point_lights_512"]
    run("point_lights", "frame: 512 lights, blocks 40x128",
        lighting_cuda.point_lighting, largs512, lkw512, cmp_lights)
    # A ragged frame height (the last block row is partial) on the same
    # planes, with the lists of the frame's block grid cut to fit.
    hh = 1000
    cut = [a[:hh] if a.dim() >= 2 and a.shape[0] == largs[0].shape[0]
           else a for a in largs[:7]]
    n_by = -(-hh // lkw["block_h"])
    run("point_lights", "ragged 1000x1920", lighting_cuda.point_lighting,
        (*[c.contiguous() for c in cut], largs[7], largs[8][:n_by].contiguous(),
         largs[9][:n_by].contiguous()), lkw, cmp_lights)
    replay("point_lights", lighting_cuda.point_lighting, cmp_bits,
           [("frame3t", "16 lights, textured GBuffer"),
            ("config5", "16 lights, 512^2, engine tick")])
    # The golden scene with the kernel asked for: the deferred pass's call,
    # then the forward sphere's, its lists culled against its own surface.
    g_calls = paths["golden_points"]["all:point_lights"]
    check(len(g_calls) == 2, f"golden: K5 called {len(g_calls)} times")
    for (gargs, gkw), what in zip(g_calls, ("deferred", "forward")):
        run("point_lights", f"golden_points: {what} pixels",
            lighting_cuda.point_lighting, gargs, gkw, cmp_bits)
    call = lambda: lighting_cuda.point_lighting(  # noqa: E731
        *largs, backend="cuda", **lkw)
    times = kernel_times(call, 20)
    ms_512 = graph_ms(lambda: lighting_cuda.point_lighting(
        *largs512, backend="cuda", **lkw512), 20)
    plain_ms = cuda_ms(lambda: lighting_cuda.point_lighting(
        *largs, backend="torch", **lkw), 2)
    acc, tile_cnt = largs[0], largs[9]
    h, w = acc.shape[:2]
    bh = lkw["block_h"]
    rows_in_block = torch.clamp(
        h - torch.arange(tile_cnt.shape[0], device=acc.device) * bh, max=bh)
    pairs = int((tile_cnt.long() * rows_in_block[:, None]).sum()) * 128
    # What these lists need: every pixel reads its partial sum and writes
    # its result (24 B); only pixels of blocks with a light read their
    # surface (4 x 12 + 2 x 4 B); the lights and lists of those blocks.
    lit_px = int(((tile_cnt > 0).long() * rows_in_block[:, None]).sum()) * 128
    n_bytes = (h * w * 24 + lit_px * 56
               + int(tile_cnt.sum()) * (16 * 4 + 4) + tile_cnt.numel() * 4)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = pairs * OPS_PER_PIXEL_LIGHT / PEAK_FP32_PER_S * 1e3
    rows.append(dict(name="point_lights", route="cuda",
                     **KERNELS["point_lights"],
                     launches=frame_launches["point_lights"],
                     launches_per_frame_by_path=by_path("point_lights"),
                     max_abs_err=lmain["max_abs_err"], **times,
                     plain_ms=plain_ms,
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     pixel_light_pairs=pairs, lit_pixels=lit_px,
                     bytes=n_bytes,
                     ms_512_lights=ms_512,
                     # No PyTorch call shades a culled light list.
                     library_ms=None))

    # ---- K6 pcf_window: bit for bit, and the same window origins
    (w_sm, w_sc), w_kw = captured["pcf_window"]
    check(w_sc.shape[0] % w_kw["tile_h"] != 0,
          "the frame's rows are a multiple of its tile: no ragged tile")
    wmain = pcf_window_cases(
        run, w_sm, w_sc, w_kw, "frame: pcf_backend=pallas, tiles "
        f"{w_kw['tile_h']}x{w_kw['tile_w']}, {w_sc.shape[0]} rows")
    for label, (sm_c, sc_c, kw_c) in pcf_window_extra_cases(rng).items():
        pcf_window_cases(run, sm_c, sc_c, kw_c, label)
    call = lambda: pcf_window.compute_pcf_pallas(  # noqa: E731
        w_sm, w_sc, backend="cuda", **w_kw)
    times = kernel_times(call, 20)
    with staged_texels(0):
        direct_ms = graph_ms(call, 20)
    plain_ms = cuda_ms(lambda: pcf_window.compute_pcf_pallas(
        w_sm, w_sc, backend="torch", **w_kw), 3)
    radius = w_kw["radius"]
    n_px = w_sc.shape[0] * w_sc.shape[1]
    inp = pcf_window.pcf_window_inputs(
        w_sc, w_sm.shape[-1], radius, w_kw["scale"], w_kw["bias"],
        w_kw["tile_h"], w_kw["tile_w"], w_kw["win"], w_kw["valid"])
    n_in = int(inp.inrange.sum())
    # Each coordinate (16 B) and valid flag (1 B) read once, each factor
    # written once, the map read once; the taps of in-range pixels.
    n_bytes = n_px * (16 + 1 + 4) + w_sm.numel() * 4
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_in * (2 * radius + 1) ** 2 * OPS_PER_TAP / PEAK_FP32_PER_S * 1e3
    rows.append(dict(name="pcf_window", route="cuda", **KERNELS["pcf_window"],
                     launches=frame_launches["pcf_window"],
                     launches_per_frame_by_path=by_path("pcf_window"),
                     max_abs_err=wmain["max_abs_err"], **times,
                     whole_ms=graph_ms(call, 20),
                     backend_launches=device_launches(call),
                     ms_direct_taps=direct_ms,
                     plain_ms=plain_ms,
                     **pcf_window_stage(inp, radius, w_kw["scale"],
                                        w_kw["tile_h"], w_kw["tile_w"]),
                     bytes=n_bytes, in_range_pixels=n_in,
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     # No PyTorch call filters inside per-tile windows.
                     library_ms=None))

    # ---- K7 / K8 window tables: pure data movement, exactly equal
    def cmp_exact(k, p):
        err = float((k - p).abs().max())
        check(torch.equal(k, p), f"tables differ (max-abs {err})")
        return {"max_abs_err": err}

    odd = torch.from_numpy(rng.random((37, 53)).astype(np.float32)).cuda()
    # D < 8: the 8-wide window wraps the row more than once.
    tiny = torch.from_numpy(rng.random((5, 5)).astype(np.float32)).cuda()
    narrow = torch.from_numpy(rng.random((3, 2)).astype(np.float32)).cuda()
    for name, fn, label in (
            ("pcf_window_table", pcf_tables.build_pcf_window_table,
             "frame: pcf_backend=packed_roll"),
            ("pcf_window2d_table", pcf_tables.build_pcf_window2d_table,
             "frame: pcf_backend=window_roll")):
        targs, tkw = captured[name]
        tmain = run(name, label, fn, targs, tkw, cmp_exact)
        run(name, "ragged 37x53 map", fn, (odd,), tkw, cmp_exact)
        run(name, "5x5 map (wraps twice)", fn, (tiny,), tkw, cmp_exact)
        run(name, "3x2 map", fn, (narrow,), tkw, cmp_exact)
        if name == "pcf_window2d_table":
            run(name, "half_wr frame", fn,
                *captured["pcf_window2d_table_half"], cmp_exact)
            run(name, "ragged 37x53, w_y 13", fn, (odd,),
                dict(lo_x=-3, lo_y=-6, w_y=13), cmp_exact)
        sm_t = targs[0]
        call = lambda: fn(*targs, backend="cuda", **tkw)  # noqa: E731
        times = kernel_times(call, 20)
        plain_ms = cuda_ms(lambda: fn(*targs, backend="torch", **tkw), 3)
        out = fn(*targs, backend="cuda", **tkw)
        # K8: no single call wraps both axes of a 2-D window without an
        # index as large as the table.
        timing = dict(times, plain_ms=plain_ms, library_ms=None)
        if name == "pcf_window_table":
            # One index_select of the map's columns is the same table: its
            # (D, D*8) result is the (D*D, 8) table, row-major.
            cols = pcf_tables._wrapped(sm_t.shape[1], tkw["lo"], 8,
                                       sm_t.device).reshape(-1)
            check(torch.equal(torch.index_select(sm_t, 1, cols).reshape(
                out.shape), out), "index_select table differs")
            library = lambda: torch.index_select(sm_t, 1, cols)  # noqa: E731
            # The one-thread-per-group design this kernel replaced is K8's
            # kernel at w_y = 1: each 16-byte group straight from the map.
            per_group = lambda: pcf_tables._launch(  # noqa: E731
                "pcf_window2d_table", sm_t, tkw["lo"], 0, 1)
            check(torch.equal(per_group(), out),
                  "the per-group design's table differs")
            timing.update(
                library_ms=graph_ms(library, 20),
                library_eager_ms=cuda_ms(library, 20),
                per_group_design_ms=graph_ms(per_group, 20),
                per_group_design_eager_ms=cuda_ms(per_group, 20))
        rows.append(dict(name=name, route="cuda", **KERNELS[name],
                         launches=frame_launches[name],
                         launches_per_frame_by_path=by_path(name),
                         max_abs_err=tmain["max_abs_err"], **timing,
                         **bytes_bound(sm_t.numel() * 4 + out.numel() * 4)))
    # ---- fma: one rounding; bit for bit with its plain version (compared
    # as bits, so a zero's sign counts) on every call of each path's frame.
    def cmp_fma(k, p):
        err = float((k - p).abs().max())
        check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
              f"not bit for bit (max-abs {err})")
        return {"max_abs_err": err}

    fma = transforms.fma_f32
    f_calls = paths["frame"]["all:fma"]
    check(len(f_calls) == MAIN_PATH["fma"],
          f"frame: fma called {len(f_calls)} times")
    for path, noted in paths.items():
        calls = noted["all:fma"]
        errs = [cmp_fma(fma(*a, backend="cuda", **kw),
                        fma(*a, backend="torch", **kw))["max_abs_err"]
                for a, kw in calls]
        checks.setdefault("fma", []).append(
            {"case": f"{path}: all {len(calls)} calls of a frame",
             "max_abs_err": max(errs)})
    # Double rounding (the first value: an fp64 sum on an fp32 midpoint),
    # cancellation, subnormal results, broadcast operands, scalars and
    # strided views.
    f32 = np.float32
    va = [f32(1 + 2.0 ** -23)]
    vb = [f32(2.0 ** -24 * (1 - 2.0 ** -23))]
    vc = [f32(1 + 2.0 ** -23)]
    for scale in (1.0, 1e-4, 1e4, 1e-20, 1e17):
        va += list(rng.standard_normal(4000).astype(f32))
        vb += list((rng.standard_normal(4000) * scale).astype(f32))
        vc += list((rng.standard_normal(4000) * scale * scale).astype(f32))
    va, vb, vc = (torch.from_numpy(np.array(x, f32)).cuda()
                  for x in (va, vb, vc))
    vc[1::7] = -(va[1::7].double() * vb[1::7].double()).float()
    run("fma", "20,001 values: double rounding, cancellation, subnormal "
        "results", fma, (va, vb, vc), {}, cmp_fma)
    grid = va[:4000].reshape(40, 100)
    run("fma", "broadcast (40, 1) x (100,) + scalar", fma,
        (grid[:, :1], vb[:100], 0.1), {}, cmp_fma)
    run("fma", "strided views, scalar factor", fma,
        (grid[:, ::3], 7.5, grid.t()[::3].t()), {}, cmp_fma)
    run("fma", "flat views off 16-byte alignment, 4k + 3 values", fma,
        (va[1:4004], vb[2:4005], vc[3:4006]), {}, cmp_fma)
    cube = va[:4620].reshape(6, 11, 70)
    run("fma", "3 dimensions: a strided view, a stride-0 middle dim",
        fma, (cube[:, ::2], vb[:420].reshape(6, 1, 70).expand(6, 6, 70),
              vc[:36].reshape(6, 6, 1)), {}, cmp_fma)

    def out_numel(args):
        return torch.broadcast_shapes(*(a.shape for a in args
                                        if isinstance(a, torch.Tensor)))

    big_args, big_kw = max(f_calls, key=lambda c: math.prod(out_numel(c[0])))
    call = lambda: fma(*big_args, backend="cuda", **big_kw)  # noqa: E731
    times = kernel_times(call, 20)
    plain_ms = cuda_ms(lambda: fma(*big_args, backend="torch", **big_kw), 5)
    n_out = math.prod(out_numel(big_args))
    n_bytes = 4 * (n_out + sum(a.numel() for a in big_args
                               if isinstance(a, torch.Tensor)))
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * n_out / PEAK_FP32_PER_S * 1e3
    library = dict(library_ms=None)
    if all(isinstance(a, torch.Tensor) for a in big_args):
        # addcmul is the same function up to its rounding: whether it
        # fuses the multiply-add is the library's choice. The two in turns
        # (kernel, library, library, kernel, three times), each from a
        # CUDA graph of 50 calls; the medians.
        fa, fb, fc = big_args
        lib = lambda: torch.addcmul(fc, fa, fb)  # noqa: E731
        turns = {"kernel": [], "library": []}
        for _ in range(3):
            for who in ("kernel", "library", "library", "kernel"):
                turns[who].append(graph_ms(call if who == "kernel" else lib,
                                           50))
        times.update(ms=statistics.median(turns["kernel"]),
                     kernel_ms=statistics.median(turns["kernel"]),
                     ms_turns=turns["kernel"])
        library = dict(library_ms=statistics.median(turns["library"]),
                       library_ms_turns=turns["library"],
                       library_bitwise_equal=torch.equal(
                           lib().view(torch.int32), call().view(torch.int32)))
    frame_calls = lambda b: [fma(*a, backend=b, **kw)  # noqa: E731
                             for a, kw in f_calls]
    rows.append(dict(name="fma", route="cuda", **KERNELS["fma"],
                     launches=frame_launches["fma"],
                     launches_per_frame_by_path=by_path("fma"),
                     max_abs_err=max(c["max_abs_err"]
                                     for c in checks["fma"]),
                     **times, plain_ms=plain_ms,
                     shape=list(out_numel(big_args)),
                     layout=dict(zip(("sizes", "modes"), transforms.fma_layout(
                         out_numel(big_args),
                         [x.expand(out_numel(big_args)).stride()
                          if isinstance(x, torch.Tensor) else None
                          for x in big_args])[:2])),
                     frame_calls_ms=graph_ms(lambda: frame_calls("cuda"), 5),
                     frame_calls_plain_ms=cuda_ms(
                         lambda: frame_calls("torch"), 3),
                     bytes=n_bytes, bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     **library))

    # ---- triangle_setup: bit for bit with its plain version (cmp_setup)
    # on every call of each path's frame and on the seeded edge cases.
    s_calls = paths["frame"]["all:triangle_setup"]
    check(len(s_calls) == MAIN_PATH["triangle_setup"],
          f"frame: triangle_setup called {len(s_calls)} times")
    for path, noted in paths.items():
        calls = noted["all:triangle_setup"]
        checks.setdefault("triangle_setup", []).append(
            {"case": f"{path}: all {len(calls)} calls of a frame",
             **setup_replays(calls)})
    edge = setup_edge_clips()
    eclip = torch.from_numpy(np.concatenate(list(edge.values()))).cuda()
    n_e = eclip.shape[0]
    for mode, two in two_sided_modes(n_e).items():
        if mode == "mask":
            two = torch.from_numpy(two).cuda()
        vm = None if mode == "false" else torch.from_numpy(
            valid_mask(n_e)).cuda()
        for bias in (None, (1.25, 7.5)):
            run("triangle_setup", f"edge cases ({', '.join(edge)}), "
                f"two_sided {mode}, valid_mask {vm is not None}, "
                f"depth_bias {bias}", rast.triangle_setup,
                (eclip, EDGE_W, EDGE_H),
                dict(two_sided=two, valid_mask=vm, depth_bias=bias),
                cmp_setup)
    check(any(c["valid"] for c in checks["triangle_setup"][-6:]),
          "the edge cases keep no triangle")
    # Config 3's two calls: the shadow pass (depth bias) and the GBuffer.
    (sh_args, sh_kw), = [c for c in s_calls if c[1].get("depth_bias")]
    (gb_args, gb_kw), = [c for c in s_calls if not c[1].get("depth_bias")]

    def setup_call(args, kw, backend):
        return lambda: rast.triangle_setup(*args, backend=backend, **kw)

    times = kernel_times(setup_call(gb_args, gb_kw, "cuda"), 20)
    frame_setups = lambda b: [rast.triangle_setup(  # noqa: E731
        *a, backend=b, **kw) for a, kw in s_calls]
    rows.append(dict(name="triangle_setup", route="cuda",
                     **KERNELS["triangle_setup"],
                     launches=frame_launches["triangle_setup"],
                     launches_per_frame_by_path=by_path("triangle_setup"),
                     max_abs_err=max(c["max_abs_err"]
                                     for c in checks["triangle_setup"]),
                     call="GBuffer pass", **times,
                     plain_ms=cuda_ms(setup_call(gb_args, gb_kw, "torch"),
                                      3),
                     **setup_bound(gb_args, gb_kw),
                     shadow=dict(
                         call="shadow pass, depth bias",
                         ms=graph_ms(setup_call(sh_args, sh_kw, "cuda"), 20),
                         plain_ms=cuda_ms(
                             setup_call(sh_args, sh_kw, "torch"), 3),
                         **setup_bound(sh_args, sh_kw)),
                     frame_calls_ms=graph_ms(lambda: frame_setups("cuda"), 5),
                     frame_calls_plain_ms=cuda_ms(
                         lambda: frame_setups("torch"), 3),
                     # No PyTorch call computes the setup: it is ~90
                     # operations (its plain version).
                     library_ms=None))
    emit("kernels", checks=checks)
    return rows


def timed_frames(scene, meta, world, config, warm: int, timed: int):
    """``warm + timed`` frames with moving time / light roll, the launch
    counts set to 0 just before and read just after. Returns (frame_ms
    list, host_ms list, last image, last aux, launches)."""
    ops.reset_kernel_launch_counts()
    frame_ms, host_ms = [], []
    image = aux = None
    for i in range(warm + timed):
        view = build_view_state(world, config, time=i / 60.0,
                                roll_light=i * 0.02)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        image, aux = render_frame(scene, view, meta, config)
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            frame_ms.append(start.elapsed_time(end))
            host_ms.append((time.time() - t0) * 1e3)
    return frame_ms, host_ms, image, aux, ops.kernel_launch_counts()


def check_launches(launches: dict, want: dict, what: str) -> None:
    for name, count in launches.items():
        check(count == want.get(name, 0),
              f"{what}: kernel {name} launched {count} times, expected "
              f"{want.get(name, 0)}")


def noted_frame(scene, meta, world, config, view_kw=None):
    """One more frame with the kernels' arguments noted."""
    view = build_view_state(world, config,
                            **(view_kw or dict(time=0.5, roll_light=0.6)))
    with recorded_calls({}) as captured:
        image, aux = render_frame(scene, view, meta, config)
    torch.cuda.synchronize()
    return captured, image, aux


def check_image(image, aux) -> tuple:
    check(tuple(image.shape) == (1080, 1920, 3), f"image {image.shape}")
    check(bool(torch.isfinite(image).all()), "image is not finite")
    check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0,
          "image outside [0, 1]")
    covered = float((aux["tri_id"] >= 0).float().mean())
    sky = float(((aux["tri_id"] < 0) & (aux["depth"] < 1.0)).float().mean())
    check(covered > 0.05 and sky > 0.05,
          f"covered {covered:.3f} / sky {sky:.3f} fraction below 5 %")
    sf = aux["shadow_factor"][aux["tri_id"] >= 0]
    check(float(sf.min()) < float(sf.max()), "shadow factor is constant")
    check(float(image.std()) > 0.02, "image is flat")
    return covered, sky, sf


def config1() -> EngineConfig:
    """bench.py's config 1 (bench.py:213-230): forward PBR at 512x512."""
    return EngineConfig(width=512, height=512, shadowmap_dim=256,
                        enable_shadow=False, enable_skydome=False,
                        texture_size=128, cubemap_size=64,
                        background_size=128, max_point_lights=8)


def forward_scene(config, device="cuda"):
    """Config 1's scene: one forward sphere, no skydome (bench.py's
    procedural stand-in for Content/Models/sphere.obj, which the repository
    does not hold), the camera and moon of bench.py's make_world."""
    b = SceneBuilder(config)
    b.enable_skydome = False
    b.add_object(make_sphere(1.0, rings=48, sectors=96), b.add_material({}),
                 deferred=False)
    scene, meta = b.build(device)
    w = World()
    w.main_camera = CameraDesc(position=np.float32([0.0, -3.0, 1.0]),
                               lookat=np.float32([0.0, 0.0, 0.0]),
                               z_far=60.0)
    moon = np.float32([20.0, 0.0, 20.0])
    w.directional_lights = [
        LightDesc(position=moon, type=0,
                  color=np.float32([1.0, 0.95, 0.85]), intensity=3.0,
                  direction=moon / np.linalg.norm(moon))]
    return scene, meta, w


def phase_frame3t():
    """Bench config 3t: the config-3 frame of the demo scene with per-slot
    PBR textures (varying channels through the mip-pair atlas fetch) and
    the variable-lod cube reflection (the half-resolution mip-pair cube):
    2 warm-up + 6 timed 1080p frames, K1-K5 once per frame."""
    config = config3()  # bench.py:410-428: config 3's frame
    t0 = time.time()
    scene, meta, world = build_textured_demo_scene(config, grass=10000,
                                                   rocks=65)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    check(meta.tex_channels == (0, 1, 2, 3, 4, 9, 10, 11),
          f"tex_channels {meta.tex_channels}")
    check(scene.cube_const is None and scene.cube_pair1 is not None,
          "config 3t does not take the variable-lod reflection")
    warm, timed = 2, 6
    torch.cuda.reset_peak_memory_stats()
    frame_ms, host_ms, image, aux, launches = timed_frames(
        scene, meta, world, config, warm, timed)
    check_launches(launches, {k: v * (warm + timed)
                              for k, v in MAIN_PATH.items()}, "frame3t")
    covered, sky, sf = check_image(image, aux)
    captured, _, _ = noted_frame(scene, meta, world, config)
    SCENES["frame3t"] = (scene, meta, world, config)
    busy = phase_profile(scene, meta, world, config, phase="profile_frame3t")
    emit("frame3t", frame_ms=statistics.median(frame_ms),
         frame_ms_all=frame_ms, host_frame_ms=statistics.median(host_ms),
         device_busy_ms=busy["device_busy_ms"],
         device_launches=busy["device_launches"],
         frames=timed, warmup=warm, triangles=meta.num_triangles,
         instances=meta.num_instances, tex_channels=list(meta.tex_channels),
         combined_atlas=list(scene.combined_atlas.shape),
         cube_pair1=list(scene.cube_pair1.shape),
         light_drops=int(aux["light_drops"]),
         live_pairs={k: int(v) for k, v in aux["live_pairs"].items()},
         pair_overflow=int(aux["pair_overflow"]),
         covered_fraction=covered, sky_fraction=sky,
         image_std=float(image.std()),
         scene_build_s=round(build_s, 2),
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
         launches=launches)
    return captured, launches, warm + timed


def phase_forward():
    """Bench config 1: a forward-shaded sphere at 512x512, no shadow map,
    no skydome, no point light: 2 warm-up + 8 timed frames through K2 (with
    the far plane as its initial depth) and K3 once per frame."""
    config = config1()
    t0 = time.time()
    scene, meta, world = forward_scene(config)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    check(meta.has_forward and not meta.has_deferred,
          "config 1 is not forward only")
    warm, timed = 2, 8
    torch.cuda.reset_peak_memory_stats()
    frame_ms, host_ms, image, aux, launches = timed_frames(
        scene, meta, world, config, warm, timed)
    check_launches(launches, {k: v * (warm + timed)
                              for k, v in FORWARD_PATH.items()}, "forward")
    check(tuple(image.shape) == (config.height, config.width, 3),
          f"image {image.shape}")
    check(bool(torch.isfinite(image).all()), "image is not finite")
    fwd = float((aux["forward_tri_id"] >= 0).float().mean())
    check(0.2 < fwd < 0.9, f"forward coverage {fwd:.3f}")
    check(bool((aux["tri_id"] < 0).all()), "a deferred pixel in config 1")
    check(float(image[aux["forward_tri_id"] >= 0].std()) > 0.02,
          "the sphere is flat")
    captured, _, _ = noted_frame(scene, meta, world, config)
    busy = phase_profile(scene, meta, world, config, phase="profile_forward")
    emit("forward", frame_ms=statistics.median(frame_ms),
         frame_ms_all=frame_ms, host_frame_ms=statistics.median(host_ms),
         device_busy_ms=busy["device_busy_ms"],
         device_launches=busy["device_launches"],
         frames=timed, warmup=warm, triangles=meta.num_triangles,
         tile=(config.tile_h, config.tile_w),
         live_pairs={k: int(v) for k, v in aux["live_pairs"].items()},
         forward_fraction=fwd, light_drops=int(aux["light_drops"]),
         scene_build_s=round(build_s, 2),
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
         launches=launches)
    return captured, launches, warm + timed


def config4_culls(scene, view, config) -> dict:
    """Meshlets kept by the frame's camera cull and by its shadow cull, as
    ``render_rows`` calls them."""
    vp = transforms.mat4_product(view.view_proj, view.model)
    sp = transforms.mat4_product(view.shadow_space, view.model)
    cam = frame_graph.meshlet_cull(scene.meshlet_records, vp,
                                   view.camera_pos, model=view.model)
    sh = frame_graph.meshlet_cull(scene.meshlet_records, sp,
                                  view.dir_lights[0, 0, :3], model=view.model,
                                  cone=config.shadow_cone_cull)
    return {"camera": int(cam.sum()), "shadow": int(sh.sum())}


def phase_frame4():
    """Bench config 4: 1,030,400 triangles in 14,004 meshlets baked by the
    native builder, culled (frustum + cone, the camera's and the light's)
    and compacted (384 k camera slots, 96 k shadow slots) every frame, at
    1024x1024 with 32x128 tiles: 2 warm-up + 8 timed frames, K1-K4 once per
    frame. The frame at time 0 is noted for phase kernels and checked:
    finite, a triangle at the centre pixel, no compaction or pair
    overflow."""
    config = config4()
    t0 = time.time()
    scene, meta, world, bake_s = config4_scene(config)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    check(native.available(), "the native meshlet builder did not load")
    check((meta.num_triangles, meta.num_meshlets) == (1030400, 14004),
          f"config 4 has {meta.num_triangles} triangles in "
          f"{meta.num_meshlets} meshlets")
    warm, timed = 2, 8
    torch.cuda.reset_peak_memory_stats()
    frame_ms, host_ms, image, aux, launches = timed_frames(
        scene, meta, world, config, warm, timed)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    check_launches(launches, {k: v * (warm + timed)
                              for k, v in FRAME4_PATH.items()}, "frame4")
    captured, image, aux = noted_frame(scene, meta, world, config,
                                       dict(time=0.0))
    h, w = config.height, config.width
    check(tuple(image.shape) == (h, w, 3), f"image {image.shape}")
    check(bool(torch.isfinite(image).all()), "image is not finite")
    check(int(aux["tri_id"][h // 2, w // 2]) >= 0,
          "no triangle at the centre")
    overflow = {k: int(aux[k]) for k in ("compact_overflow",
                                         "pair_overflow")}
    check(overflow == {"compact_overflow": 0, "pair_overflow": 0},
          f"config 4 overflowed at time 0: {overflow}")
    (setup_sh, _), (setup_gb, _) = captured["build_pairs"]
    SCENES["config4"] = (scene, meta, world, config)
    kept = config4_culls(scene, build_view_state(world, config, time=0.0),
                         config)
    busy = phase_profile(scene, meta, world, config, phase="profile_frame4")
    emit("frame4", frame_ms=statistics.median(frame_ms),
         frame_ms_all=frame_ms, host_frame_ms=statistics.median(host_ms),
         device_busy_ms=busy["device_busy_ms"],
         device_launches=busy["device_launches"],
         frames=timed, warmup=warm, triangles=meta.num_triangles,
         meshlets=meta.num_meshlets, native_builder_loaded=True,
         bake_s=round(bake_s, 2), scene_build_s=round(build_s, 2),
         meshlets_kept_time0=kept,
         live_triangles_time0={"camera": int(setup_gb.valid.sum()),
                               "shadow": int(setup_sh.valid.sum())},
         compaction_caps={"camera": config.compact_tris,
                          "shadow": config.compact_tris_shadow},
         live_pairs_time0={k: int(v) for k, v in aux["live_pairs"].items()},
         overflow_time0=overflow,
         covered_fraction=float((aux["tri_id"] >= 0).float().mean()),
         image_std=float(image.std()), peak_memory_mb=peak_mb,
         tile=(config.tile_h, config.tile_w), launches=launches)
    return captured, launches, warm + timed


def config5() -> EngineConfig:
    """bench.py's config 5 (bench.py:345-347), nothing changed: the
    engine's defaults beside it (32x128 tiles, two frames in flight,
    mailbox present)."""
    return EngineConfig(width=512, height=512, shadowmap_dim=512,
                        texture_size=128, cubemap_size=64,
                        background_size=128, max_point_lights=16)


def config5_world(camera=None) -> World:
    """bench.py's config-5 world: the demo world with 200 instances of
    each grass species, the camera at ``camera`` when given."""
    w = make_demo_world()
    w.object_descs[3].instance_count = 200
    w.object_descs[4].instance_count = 200
    if camera is not None:
        w.main_camera.position = np.float32(camera)
    return w


def phase_config5():
    """Bench config 5 as bench.py:336-408 runs it, on the port: the
    engine at its present defaults (mailbox, two frames in flight) with
    its livelink on a free port, a streamer thread pushing a fresh world
    every 50 ms with the camera at (5 + 0.1 i, 5, 5); one warm tick, 32
    timed ticks, a device synchronise. Checks: a push reloaded, camera
    pushes rebuilt nothing, every presented frame is uint8 512x512x3 and
    not flat, K1-K5 once per rendered frame, and a frame after a camera
    push differs from the one before. Then one tick's arguments noted for
    phase kernels, one tick profiled, and Engine.profile_passes."""
    config = config5()
    check((config.frames_in_flight, config.present_mode, config.tile_h,
           config.tile_w) == (2, "mailbox", 32, 128),
          "config 5 is not at the engine's defaults")
    t0 = time.time()
    engine = Engine(config=config, world=config5_world(), livelink_port=0)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    engine.start()
    try:
        return _drive_config5(engine, config, build_s)
    finally:
        engine.stop()


def _drive_config5(engine, config, build_s):
    port = engine.server.port
    meta = engine.meta
    view = build_view_state(engine.world, config)
    check(frame_graph.point_light_route(view, config) == "kernel",
          "config 5's point lights do not take the kernel")
    check(not meta.has_forward and meta.enable_skydome,
          "config 5 is not a deferred frame with a skydome")
    engine.tick()  # warm
    scene0 = engine.scene
    stop = threading.Event()
    pushes = []

    def streamer():
        i = 0
        while not stop.is_set():
            w = config5_world(camera=(5.0 + 0.1 * i, 5.0, 5.0))
            try:
                send_data_to_engine(w.to_json(), port=port)
            except OSError as e:
                pushes.append(e)
                return
            pushes.append(i)
            i += 1
            time.sleep(0.05)

    thread = threading.Thread(target=streamer, daemon=True)
    thread.start()
    n = 32
    rendered0, dropped0 = engine.stats.frame_index, engine.stats.presents_dropped
    ops.reset_kernel_launch_counts()
    frames, tick_frame_ms = [], []
    t0 = time.time()
    for _ in range(n):
        frames.append(engine.tick())
        tick_frame_ms.append(engine.stats.frame_ms)
    torch.cuda.synchronize()
    total = time.time() - t0
    launches = ops.kernel_launch_counts()
    stop.set()
    thread.join(timeout=10.0)
    check(not thread.is_alive(), "the streamer did not stop")
    check(not any(isinstance(p, OSError) for p in pushes),
          f"config5: a push failed: {pushes[-1]}")
    rendered = engine.stats.frame_index - rendered0
    check(rendered == n, f"{rendered} frames rendered for {n} ticks")
    # Kernels fma and triangle_setup follow the frame's passes (as in
    # config 3's frame): a whole number of launches a frame.
    check_launches(launches, dict({k: n for k in CONFIG5_KERNELS},
                                  fma=launches["fma"],
                                  triangle_setup=launches["triangle_setup"]),
                   "config5")
    for k in ("fma", "triangle_setup"):
        check(launches[k] % n == 0 and launches[k] > 0,
              f"config5: {k} {launches[k]}")
    check(engine.stats.reloads >= 1, "config5: no streamed world reloaded")
    check(engine.scene is scene0, "config5: a camera push rebuilt the scene")
    for img in frames:
        check(img.dtype == np.uint8 and img.shape == (512, 512, 3),
              f"config5 presented {img.dtype} {img.shape}")
        check(float(img.std()) > 5.0, "config5: a presented frame is flat")
    reloads = engine.stats.reloads
    # A frame after one more camera push differs from the one before it
    # (mailbox: the newest fetched frame, a few ticks at most).
    before = engine.tick()
    send_data_to_engine(config5_world(camera=(9.0, 2.0, 6.0)).to_json(),
                        port=port)
    deadline = time.time() + 10.0
    while engine.server._pending is None and time.time() < deadline:
        time.sleep(0.005)
    moved = False
    for _ in range(8):
        img = engine.tick()
        torch.cuda.synchronize()
        if not np.array_equal(img, before):
            moved = True
            break
        time.sleep(0.02)
    check(moved, "config5: the frame after a camera push did not change")
    check(engine.scene is scene0, "config5: a camera push rebuilt the scene")
    # The kernel arguments of the engine's frame for phase kernels (the
    # frame alone: the view's matrices are host work), one tick profiled.
    view = build_view_state(engine.world, config)
    with recorded_calls({}) as captured:
        render_frame(engine.scene, view, engine.meta, config)
    torch.cuda.synchronize()
    busy = device_profile(engine.tick, "profile_config5")
    pass_ms = engine.profile_passes(reps=5)
    # frame_ms: the median over the timed ticks of FrameStats.frame_ms
    # (host time of render plus present; dispatch time under mailbox).
    emit("config5", fps=n / total,
         frame_ms=statistics.median(tick_frame_ms),
         frame_ms_all=tick_frame_ms, frame_ms_last_tick=tick_frame_ms[-1],
         tick_ms_mean=total / n * 1e3, ticks=n, seconds=total,
         reloads=reloads, pushes=len(pushes),
         presents_dropped=engine.stats.presents_dropped - dropped0,
         triangles=engine.stats.triangles, instances=meta.num_instances,
         point_lights=int(view.lights_count[1]),
         tile=(config.tile_h, config.tile_w),
         launches_per_frame={k: v / n for k, v in launches.items()},
         device_busy_ms_one_tick=busy["device_busy_ms"],
         device_launches_one_tick=busy["device_launches"],
         pass_ms=pass_ms, scene_build_s=round(build_s, 2),
         mean_level=float(frames[-1].mean()))
    return captured, launches, n


def phase_editor() -> None:
    """The editor protocol on the card, config 5 under fifo with two
    frames in flight and the validation counters on: GetOutliner; the
    directional light's intensity set to 0, which the tick right after
    the edit does not present yet (one frame in flight ahead of it) and
    the tick after does (darker by more than 1 on the u8 scale), then
    restored; an object's instance count, which rebuilds the scene;
    GetStats with the validation counters."""
    config = config5().replace(present_mode="fifo", validation=True)
    engine = Engine(config=config, world=config5_world(), livelink_port=0)
    engine.start()
    try:
        port = engine.server.port
        out = editor_request({"Command": "GetOutliner"}, port=port)
        check(out["Status"] == "ok" and len(out["Objects"]) == 5
              and out["SceneTriangles"] == engine.meta.num_triangles,
              f"editor: GetOutliner {out}")
        engine.tick()
        before = engine.tick()
        intensity = engine.world.directional_lights[0].intensity
        r = editor_request({"Command": "SetDetails",
                            "Target": "DirectionalLight/0",
                            "Values": {"intensity": 0.0}}, port=port)
        check(r["Status"] == "ok" and r["Applied"] == ["intensity"],
              f"editor: SetDetails {r}")
        pending = engine.tick()
        after = engine.tick()
        levels = [float(x.mean()) for x in (before, pending, after)]
        check(levels[1] >= levels[0] - 1.0,
              f"editor: the edit presented at once (means {levels})")
        check(levels[2] < levels[0] - 1.0,
              f"editor: the edit did not present one tick later ({levels})")
        editor_request({"Command": "SetDetails",
                        "Target": "DirectionalLight/0",
                        "Values": {"intensity": intensity}}, port=port)
        engine.tick()
        restored = float(engine.tick().mean())
        check(abs(restored - levels[0]) <= 1.0,
              f"editor: restored mean {restored} against {levels[0]}")
        tris = engine.meta.num_triangles
        r = editor_request({"Command": "SetDetails", "Target": "Object/1",
                            "Values": {"instance_count": 3}}, port=port)
        check(r["Status"] == "ok", f"editor: SetDetails Object/1 {r}")
        engine.tick()
        check(engine.meta.num_triangles > tris,
              "editor: the object edit did not rebuild")
        stats = editor_request({"Command": "GetStats"}, port=port)["Stats"]
        check(set(stats["validation"]) == {
            "nonfinite_color", "nonfinite_shadowmap", "light_drops",
            "pair_overflow", "oversized_tris"},
            f"editor: validation counters {stats['validation']}")
        check(stats["validation"]["nonfinite_color"] == 0
              and stats["validation"]["nonfinite_shadowmap"] == 0,
              f"editor: nonfinite values {stats['validation']}")
        emit("editor", mean_levels=levels, restored_level=restored,
             triangles_before=tris, triangles_after=stats["triangles"],
             reloads=stats["reloads"], validation=stats["validation"],
             frames=stats["frame_index"])
    finally:
        engine.stop()


def phase_golden():
    """The committed golden scene (tests/test_golden.py::_build, built by
    the port) on the card through the kernels, in debug views 0, 1, 4, 8
    and 9, against tests/golden/*.png by tests/test_golden.py's criterion:
    fewer than 1 % of values off by more than 4/255, median at most
    1/255. Then view 0 once more with the point-light kernel asked for
    (the scene's two slots are below point_kernel_min): K5 runs for the
    deferred pixels and for the forward sphere's, each pass with its own
    culled lists, and the frame meets the same criterion."""
    config = TEST_CONFIG
    scene, meta, view = build_golden_scene(config)
    out, launches = {}, {}
    captured = None

    def held(name, image):
        gold = read_png(os.path.join(REPO, "tests", "golden",
                                     f"{name}.png"))[..., :3]
        diff = np.abs(image.cpu().numpy() - gold)
        frac = float((diff > 4 / 255).mean())
        med = float(np.median(diff))
        check(frac < 0.01 and med <= 1 / 255,
              f"golden {name}: {frac:.4f} of values off by > 4/255, "
              f"median {med}")
        return dict(fraction_off=frac, median=med, max_abs=float(diff.max()))

    for name, dv in GOLDEN_VIEWS.items():
        v = view._replace(debug_view=torch.tensor(dv, dtype=torch.int32))
        ops.reset_kernel_launch_counts()
        if dv == 0:
            with recorded_calls({}) as captured:
                image, aux = render_frame(scene, v, meta, config)
        else:
            image, aux = render_frame(scene, v, meta, config)
        torch.cuda.synchronize()
        launches[name] = ops.kernel_launch_counts()
        want = dict(GOLDEN_PATH)
        if dv != 0:
            want.pop("bilinear_tap")  # no skydome in the debug views
        check_launches(launches[name], want, f"golden {name}")
        out[name] = held(name, image)
    points_cfg = config.replace(point_light_kernel="pallas",
                                point_kernel_min=2)
    ops.reset_kernel_launch_counts()
    v = view._replace(debug_view=torch.tensor(0, dtype=torch.int32))
    with recorded_calls({}) as points:
        image, aux = render_frame(scene, v, meta, points_cfg)
    torch.cuda.synchronize()
    points_launches = ops.kernel_launch_counts()
    check_launches(points_launches, dict(GOLDEN_PATH, point_lights=2),
                   "golden, point-light kernel")
    check(int(aux["light_drops"]) == 0, "golden: point lights dropped")
    out["final_point_light_kernel"] = held("final", image)
    emit("golden", views=out, launches=launches["final"],
         launches_point_light_kernel=points_launches)
    return (captured, launches["final"]), (points, points_launches)


def phase_frame():
    """The main path: 2 warm-up + 8 timed 1080p frames of the demo scene
    at bench config 3's defaults through ``render_frame``: K1-K5 once per
    frame, K6-K8 never."""
    config = config3()
    check(config.point_light_kernel == "auto" and config.pcf_backend == "auto",
          "config 3 is not at its defaults")
    t0 = time.time()
    scene, meta, world = build_demo_scene(config, grass=10000, rocks=65)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    check(scene.pair_pos.is_cuda, "scene is not on the card")
    warm, timed = 2, 8

    torch.cuda.reset_peak_memory_stats()
    frame_ms, host_ms, image, aux, launches = timed_frames(
        scene, meta, world, config, warm, timed)
    check_launches(launches, {k: v * (warm + timed)
                              for k, v in MAIN_PATH.items()}, "frame")
    covered, sky, sf = check_image(image, aux)

    # One more frame with the kernels' arguments noted, for phase kernels.
    captured, _, _ = noted_frame(scene, meta, world, config)
    tile_cnt = captured["point_lights"][0][9]
    emit("frame", frame_ms=statistics.median(frame_ms),
         frame_ms_all=frame_ms, host_frame_ms=statistics.median(host_ms),
         frames=timed, warmup=warm, triangles=meta.num_triangles,
         instances=meta.num_instances,
         point_lights=int(build_view_state(world, config).lights_count[1]),
         light_drops=int(aux["light_drops"]),
         max_tile_cnt=int(tile_cnt.max()),
         mean_tile_cnt=float(tile_cnt.float().mean()),
         live_pairs={k: int(v) for k, v in aux["live_pairs"].items()},
         pair_overflow=int(aux["pair_overflow"]),
         covered_fraction=covered, sky_fraction=sky,
         shadow_factor_mean=float(sf.mean()),
         scene_build_s=round(build_s, 2),
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
         launches=launches)
    phase_profile(scene, meta, world, config)
    return scene, meta, world, config, captured, launches, warm + timed


def phase_lights512(scene, meta, world, config, captured: dict) -> None:
    """The same config and scene with point lights added until there are
    512, made as bench.py:456-473 makes them: 2 warm-up + 4 timed frames,
    every one through K5."""
    world = copy.copy(world)
    world.point_lights = list(world.point_lights)
    rng = np.random.RandomState(3)
    while len(world.point_lights) < 512:
        a = rng.uniform(0, 2 * np.pi)
        d = rng.uniform(0.5, 8.0)
        world.point_lights.append(LightDesc(
            position=np.array([np.sin(a) * d, np.cos(a) * d, 1.0],
                              np.float32),
            type=1,
            color=np.array([rng.uniform(0.4, 0.8), rng.uniform(0.2, 0.5),
                            0.1], np.float32),
            intensity=8.0, radius=1.5))
    warm, timed = 2, 4
    frame_ms, host_ms, image, aux, launches = timed_frames(
        scene, meta, world, config, warm, timed)
    check_launches(launches, {k: v * (warm + timed)
                              for k, v in MAIN_PATH.items()}, "lights512")
    check_image(image, aux)
    noted, _, aux_n = noted_frame(scene, meta, world, config)
    args = noted["point_lights"][0]
    check(args[7].shape[0] == 512, f"light table {tuple(args[7].shape)}")
    captured["point_lights_512"] = noted["point_lights"]
    hist = torch.bincount(args[9].flatten().long(),
                          minlength=config.max_tile_lights + 1)
    emit("lights512", frame_ms=statistics.median(frame_ms),
         frame_ms_all=frame_ms, host_frame_ms=statistics.median(host_ms),
         frames=timed, warmup=warm, point_lights=512,
         light_drops=int(aux["light_drops"]),
         light_drops_noted_frame=int(aux_n["light_drops"]),
         tile_cnt_histogram=hist.tolist(), launches=launches)
    phase_profile(scene, meta, world, config, phase="profile_lights512")


def phase_pcf_backends(scene, meta, world, config, captured: dict) -> dict:
    """One 1080p config-3 frame through each opt-in PCF backend that has a
    kernel, against the K3 frame of the same view: each backend's kernel
    once per frame and K3 never; "packed_roll" / "window_roll" give K3's
    shadow factor at every covered pixel (exact); for "pallas" and
    "half_wr" the share of covered pixels whose factor differs."""
    view_kw = dict(time=0.25, roll_light=0.4)
    _, base_img, base_aux = noted_frame(scene, meta, world, config, view_kw)
    covered = base_aux["tri_id"] >= 0
    ref = base_aux["shadow_factor"][covered]
    launches_sum = {}
    out = {}
    for backend, kernel in PCF_BACKEND_KERNEL.items():
        cfg = config.replace(pcf_backend=backend)
        ops.reset_kernel_launch_counts()
        noted, image, aux = noted_frame(scene, meta, world, cfg, view_kw)
        launches = ops.kernel_launch_counts()
        want = {k: v for k, v in MAIN_PATH.items() if k != "pcf_taps"}
        want[kernel] = 1
        check_launches(launches, want, f"pcf_backend={backend}")
        for k, v in launches.items():
            launches_sum[k] = launches_sum.get(k, 0) + v
        check(torch.equal(aux["tri_id"], base_aux["tri_id"]),
              f"{backend}: the raster changed")
        sf = aux["shadow_factor"][covered]
        diff = (sf - ref).abs()
        res = dict(launches={kernel: launches[kernel]},
                   differing_fraction=float((diff > 0).float().mean()),
                   max_abs_diff=float(diff.max()),
                   image_max_abs_diff=float((image - base_img).abs().max()))
        if backend in ("packed_roll", "window_roll") \
                and not torch.equal(sf, ref):
            # Checked after phase kernels, which replays the tables.
            FAILURES.append(f"{backend}: shadow factor differs from K3's at "
                            f"{int((diff > 0).sum())} covered pixels")
        key = kernel + ("_half" if backend == "half_wr" else "")
        captured[key] = noted[kernel]
        out[backend] = res
    # The backends without a kernel (plain PyTorch on the card) against the
    # exact filter's frame: K3 never runs; every one but half_y4 gives the
    # exact factor at every covered pixel.
    _, _, exact_aux = noted_frame(scene, meta, world,
                                  config.replace(pcf_backend="exact"),
                                  view_kw)
    exact = exact_aux["shadow_factor"][covered]
    want = {k: v for k, v in MAIN_PATH.items() if k != "pcf_taps"}
    plain = {}
    for backend in PCF_PLAIN_BACKENDS:
        cfg = config.replace(pcf_backend=backend)
        ops.reset_kernel_launch_counts()
        _, image, aux = noted_frame(scene, meta, world, cfg, view_kw)
        check_launches(ops.kernel_launch_counts(), want,
                       f"pcf_backend={backend}")
        check(torch.equal(aux["tri_id"], base_aux["tri_id"]),
              f"{backend}: the raster changed")
        diff = (aux["shadow_factor"][covered] - exact).abs()
        res = dict(differing_fraction=float((diff > 0).float().mean()),
                   max_abs_diff=float(diff.max()),
                   mean_abs_diff=float(diff.mean()),
                   image_max_abs_diff=float((image - base_img).abs().max()))
        if backend == "half_y4":
            # Reported, as "half_wr" is: the JAX package bounds it only on
            # a smooth field (tests/test_shadow.py:305-307).
            res["off_by_two_quanta_fraction"] = float(
                (diff > 2 * 0.037).float().mean())
        else:
            check(res["max_abs_diff"] == 0.0,
                  f"{backend}: the factor differs from the exact filter's "
                  f"at {int((diff > 0).sum())} covered pixels")
        plain[backend] = res
    emit("pcf_backends", covered_pixels=int(covered.sum()),
         without_kernel=plain, **out)
    return launches_sum


@contextlib.contextmanager
def seeded_images(seed: int = 31):
    """Every scene built while active gets a background image made from
    ``seed`` (``SceneBuilder.set_background_texture``; the demo world's
    own background file is not in the repository) and a smooth seeded
    sky (its own is uniform, so the dome mesh's uv would not show)."""
    build = SceneBuilder.build

    def with_background(self, *args, **kw):
        size = self.config.background_size
        rng = np.random.default_rng(seed)
        self.set_background_texture(
            rng.random((size, size, 4)).astype(np.float32))
        phase = rng.uniform(0.0, 2.0 * np.pi, (2, 4))
        t = np.arange(size, dtype=np.float64) / size * 2.0 * np.pi
        self.set_skydome_texture((0.5 + 0.25 * np.sin(
            t[None, :, None] + phase[0]) * np.cos(t[:, None, None]
                                                   + phase[1])).astype(
            np.float32))
        return build(self, *args, **kw)

    SceneBuilder.build = with_background
    try:
        yield
    finally:
        SceneBuilder.build = build


def occluded_tile_pairs(n=3000, seed=12, band: bool = False):
    """The early-out's constructed case: a 128x128 frame in 64x32 tiles, a
    full-screen quad at depth 0.05 in front of ``n`` small triangles
    (depths 0.3-0.9) crowding tile (0, 0), binned front to back (no span
    column) with a fused payload. Returns (pairs, z column). ``band``: the
    triangles crowd tile (1, 0) instead, binned for the band of tile row 1
    (64 rows, ``y0_tiles=1``)."""
    rng = np.random.default_rng(seed)
    dim = 128
    quad = np.array([[[-1, -1], [1, -1], [1, 1]],
                     [[-1, -1], [1, 1], [-1, 1]]], np.float32)
    cx = rng.uniform(0.0, 32.0, (n, 1))
    y_lo = 64.0 if band else 0.0
    cy = rng.uniform(y_lo, y_lo + 64.0, (n, 1))
    px = np.clip(cx + rng.uniform(-3.0, 3.0, (n, 3)), 0.0, 32.0)
    py = np.clip(cy + rng.uniform(-3.0, 3.0, (n, 3)), y_lo, y_lo + 64.0)
    xy = np.concatenate([quad, np.stack([px, py], -1) / dim * 2.0 - 1.0])
    z = np.concatenate([np.full((2, 3, 1), 0.05),
                        np.repeat(rng.uniform(0.3, 0.9, (n, 1, 1)), 3, 1)])
    clip = np.concatenate([xy, z, np.ones_like(z)], -1).astype(np.float32)
    setup = rast.triangle_setup(torch.from_numpy(clip).cuda(), dim, dim,
                                two_sided=True)
    extra = torch.from_numpy(rng.random((n + 2, rc.fused_extra_width()))
                             .astype(np.float32)).cuda()
    pairs = rc.build_pairs(setup, dim, 64 if band else dim, 64, 32,
                           expand=8, sort_z=True, extra=extra,
                           y0_tiles=1 if band else 0)
    return pairs, 12 + rc.fused_extra_width()


def early_out_blind_spot(b_calls, b0_calls, b_aux, b0_aux) -> dict:
    """Frame early_out_aligned (b) against frame ysort_off (b0), pass by
    pass. The early-out skips a range's later pairs once every pixel lies
    below the chunk's largest z bucket (the quantized floor of a
    triangle's smallest vertex depth); a pair whose COMPUTED fp32 depth
    falls below its own bucket (an ill-conditioned, sliver-thin
    triangle) escapes that bound. Wherever b0's winner lies at or above
    its own bucket, (b) equals (b0): a skipped pair could not have won
    there. Checks that every differing pixel or texel is such a winner;
    returns the counts."""
    out = {}
    for name, what in (("pair_raster", "shadow map"),
                       ("pair_raster_fused", "GBuffer")):
        (pb, h, w), kb = b_calls[name]
        (p0, _, _), k0 = b0_calls[name]
        z_col = k0["z_row"]
        kw0 = dict(k0)
        if name == "pair_raster":
            kw0["depth_only"] = False
            d0, t0 = rc.rasterize_pairs(p0, h, w, backend="cuda", **kw0)
            d1 = rc.rasterize_pairs(pb, h, w, backend="cuda", **kb)
            t1 = None
        else:
            d0, t0, _ = rc.rasterize_pairs_fused(p0, h, w, backend="cuda",
                                                 **kw0)
            d1, t1, _ = rc.rasterize_pairs_fused(pb, h, w, backend="cuda",
                                                 **kb)
        differ = d1.view(torch.int32) != d0.view(torch.int32)
        if t1 is not None:
            differ |= t1 != t0
        # The z bucket of each triangle, from b0's records (its z column).
        n_tri = int(p0.pair_tri.max()) + 1
        bucket = torch.zeros(n_tri, dtype=torch.float32, device=d0.device)
        bucket[p0.pair_tri.long()] = p0.records[:, z_col]
        below = (t0 >= 0) & (d0 < bucket[t0.clamp_min(0).long()])
        unexplained = int((differ & ~below).sum())
        check(unexplained == 0,
              f"early_out_aligned: {unexplained} {what} values differ from "
              "ysort_off's where the winner lies at or above its z bucket")
        out[what] = dict(differing=int(differ.sum()),
                         winners_below_their_bucket=int(below.sum()),
                         pixels=h * w)
    return out


def early_out_cases(b_calls: dict, b0_calls: dict) -> dict:
    """K1 and K2 with the occlusion early-out against their plain
    versions, skip counts included: on frame early_out_aligned's pairs
    (raster_ysort=False, aligned bins) and on the constructed occluder
    case, where the count must be positive; then both kernels' device
    times on config 3's pairs with raster_ysort=False, with and without
    the early-out, on unaligned (frame ysort_off) and aligned bins."""
    out = {"pair_raster": {}, "pair_raster_fused": {}}
    wrappers = {"pair_raster": rc.rasterize_pairs,
                "pair_raster_fused": rc.rasterize_pairs_fused}

    def counted(name, args, kw, label, fused):
        fn = wrappers[name]
        sk = torch.zeros(1, dtype=torch.int32, device="cuda")
        sp = torch.zeros(1, dtype=torch.int32, device="cuda")
        res = compare_raster(fn(*args, backend="cuda", eo_skipped=sk, **kw),
                             fn(*args, backend="torch", eo_skipped=sp, **kw),
                             fused)
        check(int(sk) == int(sp),
              f"{name}, {label}: the kernel skipped {int(sk)} pair visits, "
              f"the plain version {int(sp)}")
        out[name][label] = dict(res, skipped=int(sk), skipped_plain=int(sp))
        return int(sk)

    for name, fused in (("pair_raster", False), ("pair_raster_fused", True)):
        args, kw = b_calls[name]
        check(kw["early_out"] and kw["z_row"] >= 0 and kw["y_row"] < 0,
              f"early_out_aligned: {name} runs without the early-out")
        check(int(args[0].starts[0]) % 128 == 0 and
              bool((args[0].starts % 128 == 0).all()),
              f"early_out_aligned: {name}'s bins are not aligned")
        counted(name, args, kw, "frame early_out_aligned", fused)
    pairs, z_col = occluded_tile_pairs()
    eo = dict(tile_h=64, tile_w=32, early_out=True, z_row=z_col,
              eo_stride=1)
    for depth_only in (True, False):
        n = counted("pair_raster", (pairs, 128, 128),
                    dict(eo, depth_only=depth_only),
                    f"occluder, depth_only={depth_only}", False)
        check(n > 0, "K1 skipped nothing behind the occluder")
    with one_block_a_tile():
        n1 = counted("pair_raster", (pairs, 128, 128), eo,
                     "occluder, one block a tile", False)
    n2 = counted("pair_raster_fused", (pairs, 128, 128), eo, "occluder",
                 True)
    check(n1 > 0 and n2 == n1,
          f"occluder: K1 in one block a tile skipped {n1}, K2 {n2}")
    for name in wrappers:
        fn = wrappers[name]
        (pb, h, w), kb = b_calls[name]
        (p0, _, _), k0 = b0_calls[name]
        check(not k0["early_out"] and k0["y_row"] < 0,
              f"ysort_off: {name} is not the plain walk")
        times = {}
        for label, pp, early in (("unaligned", p0, False),
                                 ("unaligned_early_out", p0, True),
                                 ("aligned", pb, False),
                                 ("aligned_early_out", pb, True)):
            kk = dict(kb, early_out=early)
            times[label] = graph_ms(
                lambda: fn(pp, h, w, backend="cuda", **kk), 10)
        out[name]["ms_raster_ysort_off"] = times
    return out


def phase_options():
    """The remaining single-device frame options on config 3's 1080p frame
    (its scene built with a seeded background image, a smooth seeded sky
    and the merged environment table): the dome mesh with the background
    pass, the frame without y-sorted bins alone and with the occlusion
    early-out on aligned bins (equal to it wherever the early-out's rule
    holds: ``early_out_blind_spot``), the background pass, the merged
    environment tap with it (within 2e-3 of the separate taps), config 3t
    with the half-resolution reflection, and every ablation flag: 1
    warm-up + 2 timed frames each, launches per frame checked. Then one
    noted frame each; their new kernel calls replayed against the plain
    versions."""
    base = config3()
    t0 = time.time()
    with seeded_images():
        scene, meta, world = build_demo_scene(base.replace(env_merge=True),
                                              grass=10000, rocks=65)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    check(meta.enable_background and scene.env_table is not None,
          "options: the scene has no background or merged table")
    s3t, m3t, w3t, c3t = SCENES["frame3t"]
    frames, launches_sum, n_sum, noted = {}, {}, 0, {}
    for name, (change, want) in OPTION_FRAMES.items():
        if name.startswith("textured"):
            sc, me, wo, cfg = s3t, m3t, w3t, c3t.replace(**change)
        else:
            sc, me, wo, cfg = scene, meta, world, base.replace(**change)
        warm, timed = 1, 2
        frame_ms, host_ms, image, aux, launches = timed_frames(
            sc, me, wo, cfg, warm, timed)
        check_launches(launches, {k: v * (warm + timed)
                                  for k, v in want.items()}, f"options {name}")
        for k, v in launches.items():
            launches_sum[k] = launches_sum.get(k, 0) + v
        n_sum += warm + timed
        check(bool(torch.isfinite(image).all()), f"{name}: not finite")
        noted[name] = noted_frame(sc, me, wo, cfg)
        view = build_view_state(wo, cfg, time=0.7, roll_light=0.3)
        busy = device_profile(lambda: render_frame(sc, view, me, cfg),
                              f"profile_options_{name}")
        frames[name] = dict(frame_ms=statistics.median(frame_ms),
                            host_frame_ms=statistics.median(host_ms),
                            device_busy_ms=busy["device_busy_ms"],
                            device_launches=busy["device_launches"],
                            launches_per_frame={k: v / (warm + timed)
                                                for k, v in launches.items()},
                            image_mean=float(image.mean()))
    # (b) against (b0): equal wherever the early-out's rule holds; (c)
    # within 2e-3 of the separate taps.
    (b_calls, b_img, b_aux), (b0_calls, b0_img, b0_aux) = (
        noted["early_out_aligned"], noted["ysort_off"])
    blind = early_out_blind_spot(b_calls, b0_calls, b_aux, b0_aux)
    blind["image_pixels_differing"] = int((b_img != b0_img).any(-1).sum())
    env_img, bg_img = (noted[k][1] for k in ("env_merge_background",
                                             "background"))
    env_err = float((env_img - bg_img).abs().max())
    check(env_err <= 2e-3, f"env merge: max-abs {env_err} > 2e-3 against "
          "the separate taps")
    mesh_img = noted["mesh_skydome_background"][1]
    # Replays: K1 with ids and the frame's depth on the dome, K4 on the
    # background rect (as the frame called it, and over every pixel).
    m_calls = noted["mesh_skydome_background"][0]
    k1 = m_calls["all:pair_raster"]
    check(len(k1) == 2 and k1[0][1]["depth_only"]
          and not k1[1][1].get("depth_only", False)
          and k1[1][1].get("init_depth") is not None,
          "mesh skydome: K1 is not called for the shadow map, then the dome "
          "with ids and an initial depth")
    dargs, dkw = k1[1]
    dome = compare_raster(
        rc.rasterize_pairs(*dargs, backend="cuda", **dkw),
        rc.rasterize_pairs(*dargs, backend="torch", **dkw), False)
    dome["ms"] = graph_ms(lambda: rc.rasterize_pairs(
        *dargs, backend="cuda", **dkw), 10)
    dome["covered_fraction"] = float(
        (rc.rasterize_pairs(*dargs, backend="cuda", **dkw)[1] >= 0)
        .float().mean())
    k4 = m_calls["all:bilinear_tap"]
    check(len(k4) == 1, f"mesh skydome: K4 called {len(k4)} times")
    bargs, bkw = k4[0]
    rect = {}
    for label, targs in (("as called", bargs),
                         ("every pixel", (bargs[0], bargs[1], None,
                                          bargs[3]))):
        k, p = (window_tap.sample_base_window(*targs, backend=b, **bkw)[0]
                for b in ("cuda", "torch"))
        err = float((k - p).abs().max())
        check(torch.equal(k, p), f"K4 background rect ({label}): max-abs "
              f"{err}")
        rect[label] = {"max_abs_err": err}
    rect["ms"] = graph_ms(lambda: window_tap.sample_base_window(
        *bargs, backend="cuda", **bkw), 20)
    eo = early_out_cases(b_calls, b0_calls)
    emit("options", frames=frames, scene_build_s=round(build_s, 2),
         env_merge_max_abs_vs_separate=env_err,
         early_out_aligned_vs_ysort_off=blind,
         mesh_vs_analytic_mean_abs=float((mesh_img - bg_img).abs().mean()),
         dome_k1=dome, background_k4=rect, early_out=eo,
         env_table=list(scene.env_table.shape),
         launches=launches_sum, frames_counted=n_sum)
    extra = {"pair_raster": dict(options_dome=dome,
                                 options_early_out=eo["pair_raster"]),
             "pair_raster_fused": dict(
                 options_early_out=eo["pair_raster_fused"]),
             "bilinear_tap": dict(options_background_rect=rect)}
    # Phase kernels replays the dome frame's fma calls with every path's.
    return m_calls, launches_sum, n_sum, extra


def band_launches(n: int, calls: int) -> dict:
    """Launches of one banded frame of ``n`` shadow bands and ``calls``
    ``render_rows`` calls: K1 once a shadow band; K2-K5 once a call; kernel
    triangle_setup once a shadow band and once a call; kernel fma 4 a
    shadow band (the pair positions' transform 2, the shadow clip transform
    2) and 4 a call (positions and normals 2, the clip transform 2)."""
    return {"pair_raster": n, "pair_raster_fused": calls, "pcf_taps": calls,
            "bilinear_tap": calls, "point_lights": calls,
            "fma": 4 * n + 4 * calls, "triangle_setup": n + calls}


def depth_tie_ids(setup, y0: int, ids_a, ids_b, depth) -> dict:
    """Where a band's triangle ids differ from the full frame's, both
    triangles must cover the pixel at its depth exactly (the plain walk's
    arithmetic): a tie, which the pair order decides, and a band bins a
    large triangle into other ranges than the full frame does (its tile
    count is clipped to the band). ``setup`` is the pass's (ids are its
    rows)."""
    where = (ids_a != ids_b).nonzero()
    for r, c in where.tolist():
        px = torch.tensor(c + 0.5, device=depth.device)
        py = torch.tensor(float(y0 + r) + 0.5, device=depth.device)
        for t in (int(ids_a[r, c]), int(ids_b[r, c])):
            e = setup.edge[t]
            ev = [rast.edge_value(e[i, 0], e[i, 1], e[i, 2], px, py)
                  for i in range(3)]
            d = rast.plane_depth(*ev, *setup.zc[t])
            check(t >= 0 and bool(d == depth[r, c])
                  and min(float(x) for x in ev) >= 0.0,
                  f"band pixel ({y0 + r}, {c}): triangle {t} does not cover "
                  f"it at its depth {float(depth[r, c])} (got {float(d)})")
    return dict(id_mismatches=int(where.shape[0]),
                id_mismatches_all_exact_depth_ties=True)


def band_replays(calls: dict) -> tuple:
    """Every K1 and K2 call of a banded frame with ``y0_tiles`` > 0 against
    its plain version (bit for bit, ids included), every triangle_setup
    call against its plain version (``cmp_setup``), and K1's band outputs
    in call order (the shadow bands, top to bottom)."""
    out = {}
    bands = []
    for name, wrapper, fused in (("pair_raster", rc.rasterize_pairs, False),
                                 ("pair_raster_fused",
                                  rc.rasterize_pairs_fused, True)):
        errs, ids, n = [], 0, 0
        for args, kw in calls["all:" + name]:
            k = wrapper(*args, backend="cuda", **kw)
            if name == "pair_raster":
                bands.append(k)
            if kw.get("y0_tiles", 0) == 0:
                continue
            res = compare_raster(k, wrapper(*args, backend="torch", **kw),
                                 fused)
            errs.append(res["max_abs_err"])
            ids += res.get("id_mismatches", 0)
            n += 1
        check(n > 0, f"{name}: no call with y0_tiles > 0")
        out[name] = dict(calls_y0_tiles_positive=n,
                         calls=len(calls["all:" + name]),
                         max_abs_err=max(errs), id_mismatches=ids)
    out["triangle_setup"] = setup_replays(calls["all:triangle_setup"])
    return out, bands


def band_kernel_times(calls: dict, name: str, wrapper, out_words: int,
                      what: str) -> dict:
    """The device time, plain time and bound of the band call of ``name``
    with the most live pairs among those with ``y0_tiles`` > 0."""
    cands = [(args, kw) for args, kw in calls["all:" + name]
             if kw.get("y0_tiles", 0) > 0]
    args, kw = max(cands, key=lambda c: int(c[0][0].gbounds[1]))
    built = [b for b in calls["build_pairs"]
             if b[1].records is args[0].records]
    check(len(built) == 1, f"{name}: the band's pairs are not build_pairs'")
    setup, pairs = built[0]
    call = lambda: wrapper(*args, backend="cuda", **kw)  # noqa: E731
    return dict(band=what, y0_tiles=kw["y0_tiles"],
                rows=args[1], ms=graph_ms(call, 10),
                plain_ms=cuda_ms(lambda: wrapper(*args, backend="torch",
                                                 **kw), 1),
                **raster_bound(pairs, setup, args[1], args[2], kw, out_words,
                               walk=strip_walk_load(pairs, args[1], args[2],
                                                    kw),
                               path=f"bands: {what}"))


def band_edge_cases() -> dict:
    """K1 on a crowded tile of a band (split over blocks) and K1 / K2 with
    the occlusion early-out in a band, against their plain versions, skip
    counts included."""
    out = {}
    crowd = crowded_pairs(y0_tiles=1, rows=128)
    split_tiles = rc.split_parts_of(crowd, 128, 256, 64, 32)[3]
    check(bool(split_tiles.any()), "bands: the crowded band splits no tile")
    kw = dict(tile_h=64, tile_w=32, sub_rows=8, y_row=13, y0_tiles=1)
    for depth_only in (True, False):
        out[f"crowded band, depth_only={depth_only}"] = dict(
            compare_raster(
                rc.rasterize_pairs(crowd, 128, 256, backend="cuda",
                                   depth_only=depth_only, **kw),
                rc.rasterize_pairs(crowd, 128, 256, backend="torch",
                                   depth_only=depth_only, **kw), False),
            split_tiles=int(split_tiles.sum()))
    pairs, z_col = occluded_tile_pairs(band=True)
    eo = dict(tile_h=64, tile_w=32, early_out=True, z_row=z_col,
              eo_stride=1, y0_tiles=1)
    for name, fn, fused in (("pair_raster", rc.rasterize_pairs, False),
                            ("pair_raster_fused", rc.rasterize_pairs_fused,
                             True)):
        for parts in ((rc.SPLIT_PARTS, 1) if name == "pair_raster"
                      else (1,)):
            saved = rc.SPLIT_PARTS
            rc.SPLIT_PARTS = parts
            try:
                sk = torch.zeros(1, dtype=torch.int32, device="cuda")
                sp = torch.zeros(1, dtype=torch.int32, device="cuda")
                res = compare_raster(
                    fn(pairs, 64, 128, backend="cuda", eo_skipped=sk, **eo),
                    fn(pairs, 64, 128, backend="torch", eo_skipped=sp, **eo),
                    fused)
            finally:
                rc.SPLIT_PARTS = saved
            check(int(sk) == int(sp) and int(sk) > 0,
                  f"bands: {name} early-out skipped {int(sk)} pair visits, "
                  f"the plain version {int(sp)}")
            out[f"{name} early-out band, split parts {parts}"] = dict(
                res, skipped=int(sk))
    return out


def timed_calls(fn, warm: int, timed: int):
    """(median device ms by CUDA events, median host ms) of ``fn``."""
    dev_ms, host_ms = [], []
    for i in range(warm + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            dev_ms.append(start.elapsed_time(end))
            host_ms.append((time.time() - t0) * 1e3)
    return statistics.median(dev_ms), statistics.median(host_ms)


def phase_bands(scene, meta, world, config):
    """Row bands (``parallel/tiles.py``) on one card: config 3's frame
    striped over [cuda:0] * 4 and * 8 (5 and 3 strips of 64 rows a device,
    the last strips past row 1080; shadow bands of 256 and 128 rows), in
    four contiguous bands of 270 rows (K1/K2 render the tile rows that
    hold each band; the band is cropped out of them) and
    config 5's world at 512x512 in contiguous bands of 128 rows over
    [cuda:0] * 4. Each banded frame against the full frame of the same
    scene and view: launches, the image (golden criterion; a differing
    pixel lies where a band's GBuffer id differs, or differs through the
    point-light cull alone: a band's light blocks start at its own row and
    the cull's screen rectangles are not conservative, so with the lights
    unculled no other pixel may differ; ROADMAP.md §C), the gathered
    shadow map bit for bit, every band's GBuffer through ``render_rows``:
    depth bit for bit, ids but at exact depth ties (``depth_tie_ids``); every
    K1 / K2 call with y0_tiles > 0 replayed against its plain version;
    device-busy time and frame_ms beside the full frame's;
    ``band_pair_stats`` striped against contiguous. With more than one
    card, config 3 striped over the distinct cards too."""
    c5 = config5()
    w5 = config5_world()
    s5, m5 = build_scene_from_world(w5, c5)
    scenes = {"config3": (scene, meta, world, config),
              "config5": (s5, m5, w5, c5)}
    out, launches_sum, frames = {}, {}, 0
    kernel_extra = {"pair_raster": {}, "pair_raster_fused": {}}
    for case, which, n, stripe in BAND_CASES:
        sc, me, wo, cfg = scenes[which]
        mesh = make_tile_mesh([torch.device("cuda", 0)] * n)
        view = build_view_state(wo, cfg, time=0.5, roll_light=0.6)
        full, full_aux = render_frame(sc, view, me, cfg)
        ops.reset_kernel_launch_counts()
        with recorded_calls({}) as calls:
            banded = render_frame_sharded(sc, view, me, cfg, mesh,
                                          stripe=stripe)
        torch.cuda.synchronize()
        launches = ops.kernel_launch_counts()
        n_calls = n * stripe_layout(cfg, n)[0] if stripe else n
        want = band_launches(n, n_calls)
        check_launches(launches, want, f"bands {case}")
        for k, v in want.items():
            got = len(calls.get("all:" + k, []))
            check(got == v, f"bands {case}: {k} called {got} times, "
                  f"expected {v}")
        for k, v in launches.items():
            launches_sum[k] = launches_sum.get(k, 0) + v
        frames += 1
        check(tuple(banded.shape) == tuple(full.shape)
              and banded.device == full.device,
              f"bands {case}: image {tuple(banded.shape)} on {banded.device}")
        image = golden(banded, full)
        image["pixels_differing"] = int((banded != full).any(-1).sum())
        replays, bands = band_replays(calls)
        gathered = torch.cat(bands, 0)[:, :cfg.shadowmap_dim]
        full_map = full_aux["shadowmap"]
        check(torch.equal(gathered.view(torch.int32),
                          full_map.view(torch.int32)),
              f"bands {case}: the gathered shadow map differs from the "
              f"full frame's at {int((gathered != full_map).sum())} texels")
        # Every band again through render_rows on the full frame's map:
        # its GBuffer against the full frame's rows.
        th = cfg.tile_h
        if stripe:
            bands_rows = [((i + s * n) * th, th) for i in range(n)
                          for s in range(stripe_layout(cfg, n)[0])]
        else:
            bands_rows = [(i * (cfg.height // n), cfg.height // n)
                          for i in range(n)]
        mism = torch.zeros(full.shape[:2], dtype=torch.bool,
                           device=full.device)
        ties = dict(id_mismatches=0, id_mismatches_all_exact_depth_ties=True)
        for y0, rows in bands_rows:
            r1 = min(rows, cfg.height - y0)
            if r1 <= 0:
                continue
            with recorded_calls({}) as band_calls:
                _, band_aux = frame_graph.render_rows(
                    sc, view, me, cfg, y0=y0, rows=rows, full_frame=False,
                    shadowmap_override=full_aux["shadowmap"])
            a = band_aux["gbuffer_depth"][:r1]
            b = full_aux["gbuffer_depth"][y0:y0 + r1]
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"bands {case}: band rows {y0}-{y0 + r1}: GBuffer depth "
                  f"differs at {int((a != b).sum())} pixels")
            ids, full_ids = band_aux["tri_id"][:r1], \
                full_aux["tri_id"][y0:y0 + r1]
            ties["id_mismatches"] += depth_tie_ids(
                band_calls["build_pairs"][0][0], y0, ids, full_ids,
                a)["id_mismatches"]
            mism[y0:y0 + r1] = ids != full_ids
        outside = int(((banded != full).any(-1) & ~mism).sum())
        outside_unculled = 0
        if outside:
            # The lights' screen rectangles are not conservative (both
            # packages), and a band's light blocks start at its own first
            # row: without the cull (all slots, the plain loop) every
            # such pixel must agree.
            cu = cfg.replace(point_light_kernel="unroll")
            unculled = render_frame_sharded(sc, view, me, cu, mesh,
                                            stripe=stripe)
            outside_unculled = int(((unculled != render_frame(
                sc, view, me, cu)[0]).any(-1) & ~mism).sum())
            check(outside_unculled == 0,
                  f"bands {case}: {outside_unculled} image pixels differ "
                  "from the full frame where the GBuffer ids agree, the "
                  "point lights unculled")
        band_ms, band_host_ms = timed_calls(
            lambda: render_frame_sharded(sc, view, me, cfg, mesh,
                                         stripe=stripe), 1, 3)
        full_ms, full_host_ms = timed_calls(
            lambda: render_frame(sc, view, me, cfg), 1, 3)
        busy = device_profile(
            lambda: render_frame_sharded(sc, view, me, cfg, mesh,
                                         stripe=stripe),
            f"profile_bands_{case}")
        full_busy = device_profile(lambda: render_frame(sc, view, me, cfg),
                                   f"profile_bands_{case}_full_frame")
        stats = {}
        if which == "config3" and stripe:
            for layout in ("striped", "contiguous"):
                st = band_pair_stats(sc, view, me, cfg, mesh,
                                     stripe=layout == "striped")
                stats[layout] = dict(
                    per_device=st.tolist(),
                    pairs_max_over_mean=float(st[:, 1].max()
                                              / st[:, 1].mean()),
                    live_max_over_mean=float(st[:, 0].max()
                                             / st[:, 0].mean()))
        if case == "config3_striped_4":
            kernel_extra["pair_raster"] = band_kernel_times(
                calls, "pair_raster", rc.rasterize_pairs, 1,
                "config 3 shadow band, [cuda:0] * 4")
            kernel_extra["pair_raster_fused"] = band_kernel_times(
                calls, "pair_raster_fused", rc.rasterize_pairs_fused,
                2 + rc.ATTR_CH, "config 3 strip, [cuda:0] * 4")
        out[case] = dict(
            devices=n, striped=stripe, render_rows_calls=n_calls,
            shadow_band_rows=cfg.shadowmap_dim // n,
            launches=launches, image_vs_full_frame=image,
            gbuffer_vs_full_frame=dict(
                bands=len(bands_rows), depth_bits_equal=True,
                image_pixels_differing_where_ids_agree=outside,
                same_lights_unculled=outside_unculled, **ties),
            replays=replays, frame_ms=band_ms, host_frame_ms=band_host_ms,
            full_frame_ms=full_ms, full_host_frame_ms=full_host_ms,
            device_busy_ms=busy["device_busy_ms"],
            device_launches=busy["device_launches"],
            full_device_busy_ms=full_busy["device_busy_ms"],
            full_device_launches=full_busy["device_launches"],
            band_pair_stats=stats)
    edge = band_edge_cases()
    multi = None
    n_cards = torch.cuda.device_count()
    if n_cards > 1 and config.shadowmap_dim % n_cards == 0:
        mesh = make_tile_mesh()
        view = build_view_state(world, config, time=0.5, roll_light=0.6)
        full, _ = render_frame(scene, view, meta, config)
        multi = dict(devices=n_cards, image_vs_full_frame=golden(
            render_frame_sharded(scene, view, meta, config, mesh), full))
    emit("bands", cases=out, edge_cases=edge, distinct_cards=multi,
         launches=launches_sum, frames=frames)
    for name in kernel_extra:
        kernel_extra[name] = {"bands": dict(
            kernel_extra[name],
            launches_per_banded_frame={c: out[c]["launches"][name]
                                       for c in out},
            replays={c: out[c]["replays"][name] for c in out},
            edge_cases={k: v for k, v in edge.items()
                        if ("pair_raster_fused" in k)
                        == (name == "pair_raster_fused")})}
    kernel_extra["triangle_setup"] = {"bands": dict(
        launches_per_banded_frame={c: out[c]["launches"]["triangle_setup"]
                                   for c in out},
        replays={c: out[c]["replays"]["triangle_setup"] for c in out})}
    return kernel_extra


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal tensors, float values compared as their bits."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def phase_rasters(scene, meta, world, config):
    """The JAX package's raster values through ``render_frame`` on the
    card, each frame beside its "auto" frame in this call: config 3 at
    1080p at "pallas" (K1 with ids for the GBuffer pass, then the gather
    path ``surface_attributes``) and at "fused" (the "auto" route); config
    1 at "pallas" (the forward pass through K1 with ids and the far plane
    as initial depth); config 5's world at 512x512 at "jnp" (every pass
    brute force, then the gather path). Each value: launches checked per
    frame, frame_ms (median of 8 after 2 warm-up), host_frame_ms, device
    busy ms and launches (torch.profiler, one frame) and peak MB. Checks:
    every K1 call of the "pallas" frames bit for bit with its plain
    version (ids included); "pallas" shadow map, depths and ids equal to
    "auto"'s and its image within the golden criterion; the "fused" frame
    equal to "auto"'s; the "jnp" image within the golden criterion of
    "auto"'s and its depths equal but at sliver texels, which only the
    brute force covers (outside the pair's bbox: nearer, ROADMAP.md §C).
    Also the device time of ``surface_attributes`` on the 1080p GBuffer.
    Returns (launches per frame of each path, K1's row additions)."""
    path_launches, stats = {}, {}

    def frames(name, sc, me, wo, cfg, want, warm=2, timed=8):
        torch.cuda.reset_peak_memory_stats()
        frame_ms, host_ms, _image, _aux, launches = timed_frames(
            sc, me, wo, cfg, warm, timed)
        check_launches(launches, {k: v * (warm + timed)
                                  for k, v in want.items()},
                       f"rasters {name}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        busy = phase_profile(sc, me, wo, cfg, phase=f"profile_rasters_{name}")
        path_launches[name] = {k: v / (warm + timed)
                               for k, v in launches.items()}
        stats[name] = dict(raster=cfg.raster,
                           frame_ms=statistics.median(frame_ms),
                           host_frame_ms=statistics.median(host_ms),
                           device_busy_ms=busy["device_busy_ms"],
                           device_launches=busy["device_launches"],
                           peak_memory_mb=peak,
                           launches_per_frame=path_launches[name])

    def noted(sc, me, view, cfg):
        with recorded_calls({}) as calls:
            image, aux = render_frame(sc, view, me, cfg)
        torch.cuda.synchronize()
        return calls, image, aux

    def k1_replays(calls, what):
        """Every K1 call of a frame against its plain version."""
        out = []
        for args, kw in calls["all:pair_raster"]:
            res = compare_raster(
                rc.rasterize_pairs(*args, backend="cuda", **kw),
                rc.rasterize_pairs(*args, backend="torch", **kw), False)
            out.append(dict(res, what=what,
                            ids=not kw.get("depth_only", False),
                            init_depth=kw.get("init_depth") is not None))
        return out

    fma_checks = []

    def fma_replays(calls, what, want):
        """Every kernel fma call of a frame (the gather path's among them)
        against its plain version, as bits."""
        errs = []
        for a, kw in calls["all:fma"]:
            k = transforms.fma_f32(*a, backend="cuda", **kw)
            p = transforms.fma_f32(*a, backend="torch", **kw)
            check(same_bits(k, p), f"{what}: fma not bit for bit")
            errs.append(float((k - p).abs().max()))
        check(len(errs) == want, f"{what}: fma called {len(errs)} times")
        fma_checks.append(dict(what=what, calls=len(errs),
                               max_abs_err=max(errs)))

    # ---- config 3 at 1080p: "auto", "pallas", "fused".
    c3 = {r: config.replace(raster=r) for r in ("auto", "pallas", "fused")}
    frames("config3_auto", scene, meta, world, c3["auto"], MAIN_PATH)
    frames("config3_pallas", scene, meta, world, c3["pallas"], PALLAS_PATH)
    frames("config3_fused", scene, meta, world, c3["fused"], MAIN_PATH)
    view = build_view_state(world, config, time=0.5, roll_light=0.6)
    n3 = {r: noted(scene, meta, view, c) for r, c in c3.items()}
    calls_p, img_p, aux_p = n3["pallas"]
    _, img_a, aux_a = n3["auto"]
    _, img_f, aux_f = n3["fused"]
    k1 = k1_replays(calls_p, "config 3 pallas")
    fma_replays(calls_p, "config 3 pallas", PALLAS_PATH["fma"])
    check([c["ids"] for c in k1] == [False, True],
          f"config 3 pallas: K1 calls {[c['ids'] for c in k1]}, expected "
          "the shadow map depth only and the GBuffer with ids")
    for key in ("shadowmap", "gbuffer_depth", "tri_id", "depth"):
        check(same_bits(aux_p[key], aux_a[key]),
              f"config 3: pallas {key} differs from auto's at "
              f"{int((aux_p[key] != aux_a[key]).sum())} pixels")
        check(same_bits(aux_f[key], aux_a[key]),
              f"config 3: fused {key} differs from auto's")
    check(same_bits(img_f, img_a), "config 3: the fused image differs "
          f"from auto's at {int((img_f != img_a).sum())} values")
    covered, sky, _sf = check_image(img_p, aux_p)
    pallas_vs_auto = dict(golden(img_p, img_a),
                          values_off=int((img_p != img_a).sum()),
                          values=img_p.numel())
    # The gather path on the 1080p GBuffer: device time and launches.
    gargs, gkw = calls_p["surface_attributes"]
    gather = lambda: frame_graph.surface_attributes(  # noqa: E731
        *gargs, **gkw)
    g_busy = device_profile(gather, "profile_rasters_surface_attributes")
    g_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    h, w = gargs[2].shape
    surface = dict(device_busy_ms=g_busy["device_busy_ms"],
                   device_launches=g_busy["device_launches"],
                   eager_ms=cuda_ms(gather, 3), peak_memory_mb=g_peak,
                   gather_mb=h * w * 43 * 4 / 2 ** 20, pixels=h * w)
    # K1 with ids on the GBuffer pass: device time and bound.
    args, kw = calls_p["all:pair_raster"][1]
    setup_gb, pairs_gb = calls_p["build_pairs"][1]
    check(pairs_gb.records is args[0].records,
          "config 3 pallas: K1's GBuffer pairs are not build_pairs' second")
    call = lambda: rc.rasterize_pairs(  # noqa: E731
        *args, backend="cuda", **kw)
    k1_gbuffer = dict(ms=graph_ms(call, 10), plain_ms=cuda_ms(
        lambda: rc.rasterize_pairs(*args, backend="torch", **kw), 1),
        **raster_bound(pairs_gb, setup_gb, args[1], args[2], kw, 2,
                       walk=strip_walk_load(pairs_gb, args[1], args[2], kw,
                                            split=True),
                       path="rasters: config 3 pallas GBuffer, ids"))
    del n3, calls_p, gargs, gkw, gather, args, kw, call

    # ---- config 1 at "pallas": the forward pass through K1 with ids.
    c1 = config1()
    s1, m1, w1 = forward_scene(c1)
    frames("config1_auto", s1, m1, w1, c1, FORWARD_PATH)
    frames("config1_pallas", s1, m1, w1, c1.replace(raster="pallas"),
           PALLAS_FORWARD_PATH)
    v1 = build_view_state(w1, c1, time=0.5, roll_light=0.6)
    calls1, img1_p, aux1_p = noted(s1, m1, v1, c1.replace(raster="pallas"))
    _, img1_a, aux1_a = noted(s1, m1, v1, c1)
    k1 += k1_replays(calls1, "config 1 pallas")
    fma_replays(calls1, "config 1 pallas", PALLAS_FORWARD_PATH["fma"])
    check([(c["ids"], c["init_depth"]) for c in k1[2:]] == [(True, True)],
          "config 1 pallas: expected one K1 call, with ids and an initial "
          "depth")
    init = calls1["all:pair_raster"][0][1]["init_depth"]
    check(bool((init == 1.0).all()), "config 1: the forward pass's initial "
          "depth is not the far plane")
    for key in ("depth", "forward_tri_id"):
        check(same_bits(aux1_p[key], aux1_a[key]),
              f"config 1: pallas {key} differs from auto's")
    forward_vs_auto = dict(golden(img1_p, img1_a),
                           values_off=int((img1_p != img1_a).sum()))
    del calls1

    # ---- config 5's world at "jnp" against its "auto" frame.
    c5, w5 = config5(), config5_world()
    s5, m5 = build_scene_from_world(w5, c5)
    frames("config5_auto", s5, m5, w5, c5, MAIN_PATH)
    frames("config5_jnp", s5, m5, w5, c5.replace(raster="jnp"), JNP_PATH,
           warm=1)
    v5 = build_view_state(w5, c5, time=0.5, roll_light=0.6)
    img5_a, aux5_a = render_frame(s5, v5, m5, c5)
    calls5, img5_j, aux5_j = noted(s5, m5, v5, c5.replace(raster="jnp"))
    fma_replays(calls5, "config 5 jnp", JNP_PATH["fma"])
    del calls5
    slivers = {}
    for key in ("shadowmap", "gbuffer_depth"):
        off = aux5_j[key] != aux5_a[key]
        check(bool((aux5_j[key][off] < aux5_a[key][off]).all()),
              f"config 5 jnp: a {key} texel off the pair raster's is not "
              "nearer (only a sliver outside its bbox may be)")
        slivers[key] = int(off.sum())
    same_depth = aux5_j["gbuffer_depth"] == aux5_a["gbuffer_depth"]
    jnp_vs_auto = dict(golden(img5_j, img5_a),
                       values_off=int((img5_j != img5_a).sum()),
                       sliver_texels=slivers,
                       id_mismatches_at_equal_depth=int(
                           ((aux5_j["tri_id"] != aux5_a["tri_id"])
                            & same_depth).sum()),
                       live_pairs_jnp=list(aux5_j["live_pairs"]),
                       pair_overflow_jnp=int(aux5_j["pair_overflow"]))
    check(not aux5_j["live_pairs"] and int(aux5_j["pair_overflow"]) == 0,
          "config 5 jnp: a pass binned pairs")
    emit("rasters", card=card_line(), values=stats, k1_replays=k1,
         config3_pallas_vs_auto=pallas_vs_auto,
         config3_covered_fraction=covered, config3_sky_fraction=sky,
         config1_pallas_vs_auto=forward_vs_auto,
         config5_jnp_vs_auto=jnp_vs_auto, surface_attributes=surface,
         k1_gbuffer_ids=k1_gbuffer, fma_replays=fma_checks)
    pallas_launches = {
        p: path_launches[p]["pair_raster"]
        for p in ("config3_pallas", "config1_pallas")}
    return path_launches, {
        "pair_raster": dict(
            launches_per_frame_pallas=pallas_launches,
            pallas_gbuffer_ids=k1_gbuffer,
            max_abs_err_pallas=max(c["max_abs_err"] for c in k1)),
        "fma": dict(rasters_replays=fma_checks)}


@contextlib.contextmanager
def gather_layout(name: str):
    """Kernel gather_probe in layout ``name`` at every K: the wrapper's
    ``PRIVATE_MIN_K`` moved below or above every K (the sublane axis has
    one layout)."""
    saved = gather_probe.PRIVATE_MIN_K
    if name != "sublane":
        gather_probe.PRIVATE_MIN_K = 0 if name == "lane_private" else 1 << 31
    try:
        yield
    finally:
        gather_probe.PRIVATE_MIN_K = saved


def gather_probe_bits() -> dict:
    """Kernel gather_probe against ``gather_probe_plain`` bit for bit in
    every layout of both axes, at K 0, 1, 3, 8, 32, 33, 127 and 128 (the
    odd ones end in the unrolled loop's remainder) over 1, 4096 and 4097
    tiles."""
    k_list = (0, 1, 3, 8, 32, 33, 127, 128)
    n_cases, err = 0, 0.0
    for n_tiles in (1, 4096, 4097):
        for axis in gather_probe.AXES:
            t, idx = gather_probe.probe_inputs(n_tiles, axis, n_tiles,
                                               "cuda")
            for k_ops in k_list:
                plain = gather_probe.gather_probe(t, idx, k_ops, axis,
                                                  backend="torch")
                for name in gather_probe.AXIS_LAYOUTS[axis]:
                    with gather_layout(name):
                        kern = gather_probe.gather_probe(t, idx, k_ops, axis)
                    check(same_bits(kern, plain),
                          f"gather_probe {name}, K {k_ops}, {n_tiles} "
                          "tiles: not bit for bit")
                    err = max(err, float((kern - plain).abs().max()))
                    n_cases += 1
    return dict(cases=n_cases, k=list(k_list), tiles=[1, 4096, 4097],
                max_abs_err=err)


def gather_probe_sass():
    """The gather loop of each layout in the built library's SASS
    (``gather_probe.kernel_sass``): every gather one LDS and one FADD, no
    load shared across k; None where the toolkit has no cuobjdump."""
    try:
        loops = gather_probe.kernel_sass(_build.build())
    except FileNotFoundError:
        return None
    check(sorted(loops) == sorted(gather_probe.LAYOUTS),
          f"gather_probe SASS: loops of {sorted(loops)}")
    for name, loop in loops.items():
        check(loop["lds"] == loop["fadd"] > 0,
              f"gather_probe SASS, {name}: {loop['lds']} LDS for "
              f"{loop['fadd']} FADD in the gather loop")
    return loops


def phase_probes(scene, meta, world, config):
    """The probe tools of ``zeldaengine_tpu_torch/tools`` (the JAX
    package's ``tools/pallas_gather_probe.py`` and ``tools/walk_stats.py``)
    driven as their CLIs drive them, the launch counts set to 0 just before
    and read just after: ``gather_probe.probe`` at the tool's 4096 tiles,
    both axes, K 1, 8, 32 and 128 (kernel gather_probe); ``walk_stats.
    fma_rate`` at 1, 3 and 8 chains on the tool's 67,108,864 elements
    (kernel fma_peak); ``walk_stats.frame_passes`` and ``report`` on config
    3's scene (phase frame) and config 4's (phase frame4): the strip walk's
    tests and operations on the GBuffer pairs, its floor at the measured
    rates, kernel pair_raster_fused's time on those pairs. Then each probe
    kernel against its plain version on the card, bit for bit: gather_probe
    at every (axis, K), fma_peak at every chain count on a seeded input of
    the full size (the kernel timed from a CUDA graph, the plain version
    once, on the call that is compared); and the walk floor of the same
    frames' shadow pairs beside kernel pair_raster. Each gather_probe case
    carries its layout, counts, byte and shared-memory bounds (SM count
    from the device, maximum SM clock from nvidia-smi) and the share of
    the larger; lane K 128 also the shared layout's time
    (``conflicted_ms``). Then every layout at K 1-128 in powers of two
    (``crossover``), every layout bit for bit at the listed K over 1, 4096
    and 4097 tiles (``gather_probe_bits``), and each layout's gather loop
    in the SASS (``gather_probe_sass``). Returns (the two kernels' rows,
    the walk floors for the raster kernels' rows)."""
    ops.reset_kernel_launch_counts()
    gather = gather_probe.probe(device="cuda")
    rates = {c: walk_stats.fma_rate(c) for c in walk_stats.CHAINS}
    walks, passes = {}, {}
    for name, (s, m, w, c) in (("config3", (scene, meta, world, config)),
                               ("config4", SCENES["config4"])):
        passes[name] = walk_stats.frame_passes(s, m, w, c)
        walks[name] = walk_stats.report(name, *passes[name]["gbuffer"],
                                        rates)
    torch.cuda.synchronize()
    launches = ops.kernel_launch_counts()
    # A config-3 and a config-4 frame (at the tool's view, whose light
    # capacities give config 4's frame point-light slots: K5 runs there
    # too); probe(): a warm-up and 20 timed launches a case; fma_rate: a
    # warm-up and 5; report: a warm-up and 20 of kernel pair_raster_fused
    # on each frame's pairs.
    want = {k: MAIN_PATH.get(k, 0) + FRAME4_PATH.get(k, 0)
            for k in {*MAIN_PATH, *FRAME4_PATH}}
    want["point_lights"] += 1
    want["pair_raster_fused"] += 2 * (1 + 20)
    want["gather_probe"] = (len(gather_probe.AXES) * len(gather_probe.K_OPS)
                            * (1 + 20))
    want["fma_peak"] = len(walk_stats.CHAINS) * (1 + 5)
    check_launches(launches, want, "probes")
    # Both raster kernels beside their walk floors, timed as their rows
    # are (graph_ms): K2 on the GBuffer pairs, K1 on the shadow pairs.
    floor_rate = rates[8]["fma_ops_per_s"]
    k1_floors = {}
    for name, frame_pairs in passes.items():
        pairs, h, wd, kw = frame_pairs["gbuffer"]
        walks[name]["k2_graph_ms"] = graph_ms(
            lambda: rc.rasterize_pairs_fused(pairs, h, wd, **kw), 10)
        walks[name]["k2_graph_over_floor"] = (walks[name]["k2_graph_ms"]
                                              / walks[name]["floor_ms"])
        pairs, h, wd, kw = frame_pairs["shadow"]
        load = walk_stats.walk_load(pairs, h, wd, kw)
        k1_ms = graph_ms(lambda: rc.rasterize_pairs(pairs, h, wd, **kw), 10)
        floor = load["elem_ops"] / floor_rate * 1e3
        k1_floors[name] = dict(load, floor_ms=floor, k1_graph_ms=k1_ms,
                               k1_graph_over_floor=k1_ms / floor)
    del passes

    n_tiles = 4096
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = gather_probe.max_sm_clock_hz()
    check(clock is not None, "nvidia-smi gave no maximum SM clock")
    t1_cases, crossover = [], []
    for axis in gather_probe.AXES:
        t, idx = gather_probe.probe_inputs(n_tiles, axis, 0, "cuda")
        idx64 = idx.long()
        tiles = (-1, *gather_probe.TILE)
        for k_ops in gather_probe.K_OPS:
            def call(backend="cuda"):
                return gather_probe.gather_probe(t, idx, k_ops, axis,
                                                 backend=backend)
            kern = call()
            plain, plain_ms = timed_once(lambda: call("torch"))
            check(same_bits(kern, plain),
                  f"gather_probe axis {axis}, K {k_ops}: not bit for bit")
            counts = gather_probe.probe_counts(n_tiles, k_ops)
            bounds = gather_probe.probe_bounds(counts, sms, clock)
            case = dict(axis=axis, k=k_ops, max_abs_err=float(
                (kern - plain).abs().max()), **kernel_times(call, 10),
                plain_ms=plain_ms, **ops_bound(12 * t.numel(),
                                               k_ops * t.numel()),
                layout=gather_probe.layout(axis, k_ops), **counts,
                byte_bound_ms=bounds["byte_bound_ms"],
                smem_bound_ms=bounds["smem_bound_ms"],
                larger_bound=bounds["bound_by"])
            case["share"] = max(bounds["byte_bound_ms"],
                                bounds["smem_bound_ms"]) / case["ms"]
            if axis == 1 and k_ops == max(gather_probe.K_OPS):
                # The rows as they are: the bank conflicts the private
                # layout removes.
                with gather_layout("lane_shared"):
                    case["conflicted_ms"] = graph_ms(call, 10)
            if k_ops == 1:
                # The one PyTorch call of this case (int64 indices, made
                # beforehand).
                if axis == 1:
                    def library():
                        return torch.gather(t, 1, idx64)
                else:
                    def library():
                        return torch.gather(t.view(tiles), 1,
                                            idx64.view(tiles)).view(t.shape)
                check(same_bits(library(), kern),
                      f"torch.gather differs from gather_probe, axis {axis}")
                case["library_ms"] = graph_ms(library, 10)
            t1_cases.append(case)
        # Every layout of the axis at K 1-128 in powers of two: where the
        # lane axis should take the private layout (PRIVATE_MIN_K).
        for k_ops in (2 ** e for e in range(8)):
            times = {}
            for name in gather_probe.AXIS_LAYOUTS[axis]:
                with gather_layout(name):
                    times[name] = graph_ms(
                        lambda: gather_probe.gather_probe(t, idx, k_ops,
                                                          axis), 10)
            crossover.append(dict(axis=axis, k=k_ops, ms=times))
        del t, idx, idx64
    main1 = t1_cases[0]
    check((main1["axis"], main1["k"]) == (1, 1), "T1's first case")
    t1_bits = gather_probe_bits()
    t1_sass = gather_probe_sass()

    gen = torch.Generator(device="cuda").manual_seed(13)
    a = torch.rand((walk_stats.STEPS * walk_stats.BLOCK[0],
                    walk_stats.BLOCK[1]), generator=gen,
                   device="cuda") * 2.0 - 1.0
    n_ops = walk_stats.N_OPS
    t2_cases = []
    for chains in walk_stats.CHAINS:
        def call(backend="cuda"):
            return walk_stats.fma_peak(a, chains, n_ops, backend=backend)
        kern = call()
        plain, plain_ms = timed_once(lambda: call("torch"))
        check(same_bits(kern, plain),
              f"fma_peak, {chains} chains: not bit for bit")
        err = float((kern - plain).abs().max())
        del kern, plain
        fmas = a.numel() * n_ops * chains
        t2_cases.append(dict(
            chains=chains, n_ops=n_ops, elements=a.numel(), max_abs_err=err,
            **kernel_times(call, 10), plain_ms=plain_ms,
            fma_ops_per_s=rates[chains]["fma_ops_per_s"],
            rate_ms=rates[chains]["ms"],
            **ops_bound(8 * a.numel(),
                        2 * fmas + (chains - 1) * a.numel())))
    del a
    main2 = t2_cases[-1]
    t1_card = dict(sm_count=sms, max_sm_clock_hz=clock,
                   private_min_k=gather_probe.PRIVATE_MIN_K)
    emit("probes", launches=launches, gather=gather,
         fma_rates={c: r for c, r in rates.items()}, walk_floor=walks,
         walk_floor_shadow=k1_floors, gather_probe_card=t1_card,
         gather_probe_cases=t1_cases, gather_probe_crossover=crossover,
         gather_probe_bits=t1_bits, gather_probe_sass=t1_sass,
         fma_peak_cases=t2_cases)
    rows = [
        dict(name="gather_probe", route="cuda", **KERNELS["gather_probe"],
             launches=launches["gather_probe"],
             max_abs_err=max([c["max_abs_err"] for c in t1_cases]
                             + [t1_bits["max_abs_err"]]),
             **{k: main1[k] for k in ("ms", "kernel_ms", "eager_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
             shape=[n_tiles * 8, 128], axis=1, k=1, cases=t1_cases,
             crossover=crossover, sass=t1_sass, **t1_card),
        dict(name="fma_peak", route="cuda", **KERNELS["fma_peak"],
             launches=launches["fma_peak"],
             max_abs_err=max(c["max_abs_err"] for c in t2_cases),
             **{k: main2[k] for k in ("ms", "kernel_ms", "eager_ms",
                                      "plain_ms", "bound_ms", "bound_by")},
             # No PyTorch call runs a chain of fused multiply-adds.
             library_ms=None, chains=main2["chains"], n_ops=n_ops,
             cases=t2_cases)]
    return rows, {"pair_raster_fused": {"walk_floor": walks},
                  "pair_raster": {"walk_floor": k1_floors}}


def device_profile(fn, phase: str) -> dict:
    """Where one call of ``fn`` (ending in a synchronise) spends device
    time: the ten device operations with the largest summed time
    (torch.profiler), beside the total, emitted under ``phase``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(evt):
        return float(getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)))

    # Device rows only: the host-side operator rows repeat their kernels'
    # time and would count it twice.
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in rows)
    busy = dict(device_busy_ms=total / 1e3,
                device_launches=sum(e.count for e in rows))
    # The gathers (texture and cube row fetches, record gathers) by name.
    gathers = [e for e in rows if "index" in e.key.lower()
               or "gather" in e.key.lower()]
    emit(phase, **busy,
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
         top=[{"name": e.key[:70], "ms": dev_us(e) / 1e3, "calls": e.count}
              for e in rows[:10]],
         gather_rows=[{"name": e.key[:70], "ms": dev_us(e) / 1e3,
                       "calls": e.count} for e in gathers[:8]])
    return busy


def phase_profile(scene, meta, world, config, phase="profile") -> dict:
    """Where one frame's device time goes (``device_profile`` of one
    ``render_frame`` after a warm one)."""
    view = build_view_state(world, config, time=0.7, roll_light=0.3)
    render_frame(scene, view, meta, config)
    torch.cuda.synchronize()
    return device_profile(lambda: render_frame(scene, view, meta, config),
                          phase)


def phase_frame_vs_plain() -> None:
    """256x256 frames through the kernels against the same frames through
    the plain versions, on the card: "auto" point lights with K3, and each
    PCF backend that has a kernel."""
    base = TEST_CONFIG.replace(width=256, height=256, tile_h=16, tile_w=32,
                               raster="cuda")
    check(base.point_light_kernel == "auto", "point lights are not culled")
    scene, meta, world = build_demo_scene(base, grass=200, rocks=8)
    view = build_view_state(world, base, time=0.25, roll_light=0.1)
    out = {}
    for backend in ("auto", *PCF_BACKEND_KERNEL):
        config = base.replace(pcf_backend=backend)
        ops.reset_kernel_launch_counts()
        img_k, aux_k = render_frame(scene, view, meta, config)
        launches = ops.kernel_launch_counts()
        img_p, aux_p = render_frame(scene, view, meta,
                                    config.replace(raster="torch"))
        torch.cuda.synchronize()
        check(launches["point_lights"] == 1, f"{backend}: K5 not launched")
        res = golden(img_k, img_p)
        sm_err = float((aux_k["shadowmap"] - aux_p["shadowmap"]).abs().max())
        check(sm_err <= 1e-6, f"shadow map max-abs {sm_err}")
        sf_err = float((aux_k["shadow_factor"]
                        - aux_p["shadow_factor"]).abs().max())
        check(sf_err <= 6e-8, f"{backend}: shadow factor max-abs {sf_err}")
        out[backend] = dict(
            **res, shadowmap_max_abs_err=sm_err, shadow_factor_max_abs_err=sf_err,
            tri_id_mismatches=int((aux_k["tri_id"] != aux_p["tri_id"]).sum()),
            light_drops=int(aux_k["light_drops"]))
    emit("frame_vs_plain",
         covered_fraction=float((aux_k["tri_id"] >= 0).float().mean()), **out)


def phase_engine() -> None:
    """The engine shell, the entry point behind ``python -m
    zeldaengine_tpu_torch.engine``, at its defaults: build the default demo
    world at 1080p, tick twice with one frame in flight under fifo (the
    light ring rolling: the 'L' key), check what it presents and that every
    tick went through K1-K5 once; hold K1, K2 and K6 at the engine's tiles
    against their plain versions. Then two ticks of ``Engine()`` at its
    own defaults (EngineConfig() as it is: mailbox, two frames in flight;
    livelink on a free port), through K1-K5 once each."""
    engine = Engine(EngineConfig(width=1920, height=1080, frames_in_flight=1,
                                 present_mode="fifo"), livelink_port=None)
    engine.toggle_light_roll()
    ops.reset_kernel_launch_counts()
    frames = [engine.tick() for _ in range(2)]
    launches = ops.kernel_launch_counts()
    check_launches(launches, {k: 2 * v for k, v in MAIN_PATH.items()},
                   "engine")
    for img in frames:
        check(img.dtype == np.uint8 and img.shape == (1080, 1920, 3),
              f"engine presented {img.dtype} {img.shape}")
    check(float(frames[-1].std()) > 5.0, "engine frame is flat")
    check(bool((frames[0] != frames[1]).any()), "the animation stands still")
    # K2 at the engine's default 32x128 tiles (16 pixels a thread, a lane's
    # pixels in 4 columns) on a third tick's pairs, against its plain
    # version, and its device time.
    with recorded_calls({}) as captured:
        engine.tick()
    (pairs, h, w), kw = captured["pair_raster_fused"]
    k2 = compare_raster(
        rc.rasterize_pairs_fused(pairs, h, w, backend="cuda", **kw),
        rc.rasterize_pairs_fused(pairs, h, w, backend="torch", **kw), True)
    k2.update(tile=(kw["tile_h"], kw["tile_w"]), ms=graph_ms(
        lambda: rc.rasterize_pairs_fused(pairs, h, w, backend="cuda", **kw),
        10))
    # K1 at the same tiles on the third tick's shadow pairs (16 pixels a
    # thread; the split tiles merged over 4,096-pixel tiles), depth only as
    # the frame calls it and with ids.
    (spairs, sh, sw), skw = captured["pair_raster"]
    check(skw["y_row"] >= 0, "the engine's shadow pairs carry no strip span")
    k1 = {}
    for depth_only in (True, False):
        kkw = dict(skw, depth_only=depth_only)
        k1["depth_only" if depth_only else "with_ids"] = compare_raster(
            rc.rasterize_pairs(spairs, sh, sw, backend="cuda", **kkw),
            rc.rasterize_pairs(spairs, sh, sw, backend="torch", **kkw), False)
    k1.update(tile=(skw["tile_h"], skw["tile_w"]), split_tiles=int(
        rc.split_parts_of(spairs, sh, sw, skw["tile_h"], skw["tile_w"])[3]
        .sum()), ms=graph_ms(lambda: rc.rasterize_pairs(
            spairs, sh, sw, backend="cuda", **skw), 10))
    # K6 at the engine's tiles (a block of 512 threads) on the third
    # tick's shadow map and coordinates, with its valid mask.
    (e_sm, e_sc), e_kw = captured["pcf_taps"]
    cfg = engine.config
    kkw = dict(radius=e_kw["radius"], scale=e_kw["scale"],
               bias=e_kw["bias"], tile_h=cfg.tile_h, tile_w=cfg.tile_w,
               win=cfg.pcf_window, valid=e_kw["active"])
    k6 = cmp_pcf(*(pcf_window.compute_pcf_pallas(
        e_sm, e_sc, backend=b, return_origins=True, **kkw)
        for b in ("cuda", "torch")))
    k6.update(tile=(cfg.tile_h, cfg.tile_w), ms=graph_ms(
        lambda: pcf_window.compute_pcf_pallas(e_sm, e_sc, backend="cuda",
                                              **kkw), 20))
    defaults = Engine(livelink_port=0)
    check((defaults.config.frames_in_flight, defaults.config.present_mode)
          == (2, "mailbox"), "Engine() is not at the reference's defaults")
    defaults.start()
    try:
        ops.reset_kernel_launch_counts()
        shown = [defaults.tick() for _ in range(2)]
        torch.cuda.synchronize()
        default_launches = ops.kernel_launch_counts()
    finally:
        defaults.stop()
    check_launches(default_launches,
                   {k: 2 * v for k, v in MAIN_PATH.items()},
                   "engine at its defaults")
    for img in shown:
        check(img.dtype == np.uint8 and img.shape == (1080, 1920, 3)
              and float(img.std()) > 5.0,
              f"Engine() presented {img.dtype} {img.shape}")
    emit("engine", ticks=2, frame_ms=engine.stats.frame_ms,
         triangles=engine.stats.triangles, launches=launches,
         mean_level=float(frames[-1].mean()), pair_raster=k1,
         pair_raster_fused=k2, pcf_window=k6,
         defaults=dict(ticks=2, frame_ms=defaults.stats.frame_ms,
                       presents_dropped=defaults.stats.presents_dropped,
                       livelink_port=defaults.server.port,
                       launches=default_launches))


def main() -> None:
    t0 = time.time()
    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its seconds noted under ``name``."""
        t = time.time()
        out = fn(*args)
        seconds[name] = round(time.time() - t, 1)
        return out

    info = timed("device", phase_device)
    timed("build", phase_build)
    scene, meta, world, config, captured, launches, n_frame = timed(
        "frame", phase_frame)
    timed("lights512", phase_lights512, scene, meta, world, config, captured)
    pcf_launches = timed("pcf_backends", phase_pcf_backends, scene, meta,
                         world, config, captured)
    for name in PCF_BACKEND_KERNEL.values():
        launches[name] = pcf_launches[name]

    def per_frame(counts, n):
        return {k: v / n for k, v in counts.items()}

    # Launches per frame of each path: config 3 (K6-K8 in the one frame
    # through each opt-in PCF backend), config 3t, config 1, config 4, the
    # golden scene's view 0, and that view with the point-light kernel.
    path_launches = {"frame": {k: v / n_frame if k in MAIN_PATH else v
                               for k, v in launches.items()}}
    paths = {"frame": captured}
    for path, phase in (("frame3t", phase_frame3t),
                        ("forward", phase_forward),
                        ("frame4", phase_frame4),
                        ("config5", phase_config5)):
        noted, counts, n = timed(path, phase)
        paths[path], path_launches[path] = noted, per_frame(counts, n)
    for path, (c, counts) in zip(("golden", "golden_points"),
                                 timed("golden", phase_golden)):
        paths[path], path_launches[path] = c, counts
    noted, counts, n, options_extra = timed("options", phase_options)
    paths["options"], path_launches["options"] = noted, per_frame(counts, n)
    bands_extra = timed("bands", phase_bands, scene, meta, world, config)
    rasters_launches, rasters_extra = timed("rasters", phase_rasters, scene,
                                            meta, world, config)
    path_launches.update(rasters_launches)
    probe_rows, probes_extra = timed("probes", phase_probes, scene, meta,
                                     world, config)
    rows = timed("kernels", phase_kernels, captured, launches, paths,
                 path_launches)
    for row in rows:
        row.update(options_extra.get(row["name"], {}))
        row.update(bands_extra.get(row["name"], {}))
        row.update(rasters_extra.get(row["name"], {}))
        row.update(probes_extra.get(row["name"], {}))
    # The probe kernels run on no frame path.
    for row in probe_rows:
        row["launches_per_frame_by_path"] = {
            path: counts.get(row["name"], 0)
            for path, counts in path_launches.items()}
    rows += probe_rows
    check(sorted(r["name"] for r in rows) == sorted(KERNELS),
          f"the kernels line has {len(rows)} rows for {len(KERNELS)} kernels")
    check(not FAILURES, "; ".join(FAILURES))
    timed("frame_vs_plain", phase_frame_vs_plain)
    timed("engine", phase_engine)
    timed("editor", phase_editor)
    emit("done", seconds=round(time.time() - t0, 1), phase_seconds=seconds)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
