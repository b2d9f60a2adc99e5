"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``zeldaengine_tpu_torch/csrc`` and drives the
port's main path: the 1920x1080 deferred demo frame (10000 grass instances
per species, 65 rocks, 16 point lights, tiles 64x32) through
``render_frame``. Every kernel is replayed on the inputs the frame gave it
and held against its plain PyTorch version on the card; one frame at
256x256 rendered through the kernels is held against the same frame
rendered through the plain versions, and the engine shell presents two
1080p frames. Each phase prints one JSON line; the last line is ``{"ok": true, "device": {...}}``. Any failure raises: the
script exits non-zero and prints no result. It needs a CUDA device, nvcc,
and nothing else beyond PyTorch and NumPy.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

# One card is used: unless the caller chose the cards, only the first is
# made visible, and the last line's ``count`` is that one card.
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zeldaengine_tpu_torch import EngineConfig, TEST_CONFIG  # noqa: E402
from zeldaengine_tpu_torch import ops  # noqa: E402
from zeldaengine_tpu_torch.engine import Engine  # noqa: E402
from zeldaengine_tpu_torch.ops import _build  # noqa: E402
from zeldaengine_tpu_torch.ops import pcf_cuda, rasterize as rast  # noqa: E402
from zeldaengine_tpu_torch.ops import rasterize_cuda as rc  # noqa: E402
from zeldaengine_tpu_torch.ops import window_tap  # noqa: E402
from zeldaengine_tpu_torch.passes import build_view_state, render_frame  # noqa: E402
from zeldaengine_tpu_torch.passes import frame as frame_graph  # noqa: E402
from zeldaengine_tpu_torch.scene import build_demo_scene  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet): the roofline the
# kernels' bounds are stated against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations of one (pixel, pair) test: 3 edge functions (2 mul +
# 2 add each), depth (3 mul + 2 add), edge sum (2), edge min (2), five
# compares and the select.
OPS_PER_TEST = 26
# The names under which the frame graph calls the kernels' wrappers.
FRAME_CALLS = {
    "pair_raster": "rasterize_pairs",
    "pair_raster_fused": "rasterize_pairs_fused",
    "pcf_taps": "compute_pcf_vmem",
    "bilinear_tap": "sample_base_window",
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


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_build._nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    info = dict(
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
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
    """While active, every call the frame graph makes to a kernel's wrapper
    or to ``build_pairs`` is noted in ``calls`` (references, not copies)
    and passed on unchanged: ``calls[kernel] = (args, kwargs)`` without
    the ``backend`` keyword, ``calls["build_pairs"] = [(setup, pairs), ...]``
    in call order (shadow pass first, GBuffer second)."""
    saved = {}

    def shim(name, key):
        fn = saved[name] = getattr(frame_graph, name)

        def call(*args, **kw):
            out = fn(*args, **kw)
            if key == "build_pairs":
                calls.setdefault(key, []).append((args[0], out))
            else:
                calls[key] = (args, {k: v for k, v in kw.items()
                                     if k != "backend"})
            return out
        setattr(frame_graph, name, call)

    shim("build_pairs", "build_pairs")
    for key, name in FRAME_CALLS.items():
        shim(name, key)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(frame_graph, name, fn)


def needed_tests(pairs: rc.PairedTriangles, setup, height, width, tile_h,
                 tile_w):
    """(pixel, pair) tests the function needs on this pair stream, and the
    tests the kernel makes. A pair can only cover pixels whose centre lies
    inside its triangle's bbox, so for every (tile, pair) of the dense,
    supertile and global ranges only the pixel centres of bbox & tile are
    counted; the kernel tests all tile_h * tile_w pixels of the tile."""
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
    ny = centres(bbox[:, 1], bbox[:, 3], (tile // n_tx).float() * tile_h,
                 tile_h)
    return int((nx * ny).double().sum()), int(tile.numel()) * tile_h * tile_w


def raster_bound(pairs, setup, height, width, kw, out_words: int) -> dict:
    tests, kernel_tests = needed_tests(pairs, setup, height, width,
                                       kw["tile_h"], kw["tile_w"])
    live = int(pairs.gbounds[1])
    n_bytes = (live * pairs.records.shape[1] * 4 + live * 4
               + (pairs.starts.numel() * 2 + pairs.sstarts.numel() * 2 + 2) * 4
               + height * width * 4 * out_words)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = tests * OPS_PER_TEST / PEAK_FP32_PER_S * 1e3
    emit("bound", pixel_pair_tests_in_bbox=tests,
         pixel_pair_tests_of_the_kernel=kernel_tests, live_pairs=live,
         bytes=n_bytes, bytes_ms=t_bytes, operations_ms=t_ops)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bytes_bound(n_bytes: int) -> dict:
    return dict(bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")


def compare_raster(kernel_out, plain_out, fused: bool) -> dict:
    """Depth max-abs <= 1e-6; triangle ids equal wherever the plain depth
    has a unique minimum - both walk pairs in the same order with the same
    arithmetic (-fmad=false), so the mismatch count must be 0; fused
    planes atol/rtol 1e-5 on covered pixels."""
    if not isinstance(kernel_out, tuple):
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    err = float((kernel_out[0] - plain_out[0]).abs().max())
    check(err <= 1e-6, f"depth max-abs {err} > 1e-6")
    out = {"max_abs_err": err}
    if len(kernel_out) > 1:
        mism = int((kernel_out[1] != plain_out[1]).sum())
        check(mism == 0, f"{mism} triangle ids differ")
        out["id_mismatches"] = mism
    if fused:
        cov = plain_out[1] >= 0
        k, p = kernel_out[2][:, cov], plain_out[2][:, cov]
        perr = (k - p).abs()
        bad = int((perr > 1e-5 + 1e-5 * p.abs()).sum())
        check(bad == 0, f"{bad} plane values beyond atol/rtol 1e-5 "
                        f"(max {float(perr.max())})")
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


def phase_kernels(captured: dict, frame_launches: dict) -> list:
    """Replay every kernel on the inputs the 1080p frame gave it (plus
    option variants and one small ragged shape), hold it against its plain
    version on the card, time both."""
    rows = []
    checks = {}

    def run(name, label, wrapper, args, kw, compare):
        k = wrapper(*args, backend="cuda", **kw)
        p = wrapper(*args, backend="torch", **kw)
        torch.cuda.synchronize()
        res = compare(k, p)
        checks.setdefault(name, []).append({"case": label, **res})
        return res

    # ---- K1 pair_raster
    (pairs, ph, pw), kw = captured["pair_raster"]
    (setup_sh, pairs_sh), (setup_gb, pairs_gb) = captured["build_pairs"]
    check(pairs_sh is pairs, "shadow pairs are not the first build_pairs call")
    main = run("pair_raster", "frame: shadow map, depth_only", rc.rasterize_pairs,
               (pairs, ph, pw), kw, lambda k, p: compare_raster(k, p, False))
    kw_ids = dict(kw, depth_only=False)
    run("pair_raster", "shadow pairs, with ids", rc.rasterize_pairs,
        (pairs, ph, pw), kw_ids, lambda k, p: compare_raster(k, p, False))
    init = torch.from_numpy(np.random.default_rng(1).uniform(
        0.9, 1.0, (ph, pw)).astype(np.float32)).cuda()
    for depth_only in (True, False):
        run("pair_raster", f"shadow pairs, init_depth, depth_only={depth_only}",
            rc.rasterize_pairs, (pairs, ph, pw, init),
            dict(kw, depth_only=depth_only),
            lambda k, p: compare_raster(k, p, False))
    small = random_pairs(3, 400, 72, 96, 24, 32, sort_z=True,
                         ysort_sub_rows=8, expand=2)
    run("pair_raster", "ragged 72x96, tiles 24x32", rc.rasterize_pairs,
        (small, 72, 96), dict(tile_h=24, tile_w=32),
        lambda k, p: compare_raster(k, p, False))
    ms = cuda_ms(lambda: rc.rasterize_pairs(pairs, ph, pw, backend="cuda",
                                            **kw), 10)
    plain_ms = cuda_ms(lambda: rc.rasterize_pairs(
        pairs, ph, pw, backend="torch", **kw), 1)
    rows.append(dict(name="pair_raster", route="cuda",
                     **KERNELS["pair_raster"],
                     launches=frame_launches["pair_raster"],
                     max_abs_err=main["max_abs_err"], ms=ms, kernel_ms=ms,
                     plain_ms=plain_ms,
                     **raster_bound(pairs, setup_sh, ph, pw, kw, out_words=1),
                     library_ms=None))

    # ---- K2 pair_raster_fused
    (fpairs, fh, fw), fkw = captured["pair_raster_fused"]
    check(pairs_gb is fpairs, "GBuffer pairs are not the second build_pairs call")
    cmp_fused = lambda k, p: compare_raster(k, p, True)  # noqa: E731
    fmain = run("pair_raster_fused", "frame: GBuffer", rc.rasterize_pairs_fused,
                (fpairs, fh, fw), fkw, cmp_fused)
    for need_uv in (True, False):
        for has_combo in (True, False):
            sp = random_pairs(
                5, 400, 72, 96, 24, 32, sort_z=True, ysort_sub_rows=8,
                extra_w=rc.fused_extra_width(need_uv, has_combo))
            run("pair_raster_fused",
                f"ragged 72x96, need_uv={need_uv}, has_combo={has_combo}",
                rc.rasterize_pairs_fused, (sp, 72, 96),
                dict(tile_h=24, tile_w=32, texture_size=64, need_uv=need_uv,
                     has_combo=has_combo, combo_const=3.0), cmp_fused)
    ms = cuda_ms(lambda: rc.rasterize_pairs_fused(
        fpairs, fh, fw, backend="cuda", **fkw), 10)
    plain_ms = cuda_ms(lambda: rc.rasterize_pairs_fused(
        fpairs, fh, fw, backend="torch", **fkw), 1)
    rows.append(dict(name="pair_raster_fused", route="cuda",
                     **KERNELS["pair_raster_fused"],
                     launches=frame_launches["pair_raster_fused"],
                     max_abs_err=fmain["max_abs_err"], ms=ms,
                     kernel_ms=ms,
                     plain_ms=plain_ms,
                     **raster_bound(fpairs, setup_gb, fh, fw, fkw,
                                    out_words=2 + rc.ATTR_CH),
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
    wild = torch.from_numpy(np.concatenate(
        [rng.uniform(-1.5, 2.5, (37, 53, 2)), rng.uniform(-0.2, 1.2, (37, 53, 1)),
         rng.uniform(-0.5, 2.0, (37, 53, 1))], -1).astype(np.float32)).cuda()
    sm_small = torch.from_numpy(
        rng.random((96, 160)).astype(np.float32)).cuda()
    run("pcf_taps", "ragged 37x53, wrap + out of range, radius 1",
        pcf_cuda.compute_pcf_vmem, (sm_small, wild),
        dict(radius=1, scale=1.5, bias=0.01), cmp_small)
    ms = cuda_ms(lambda: pcf_cuda.compute_pcf_vmem(
        sm, sc, backend="cuda", **pkw), 20)
    plain_ms = cuda_ms(lambda: pcf_cuda.compute_pcf_vmem(
        sm, sc, backend="torch", **pkw), 3)
    n_px = sc.shape[0] * sc.shape[1]
    rows.append(dict(name="pcf_taps", route="cuda", **KERNELS["pcf_taps"],
                     launches=frame_launches["pcf_taps"],
                     max_abs_err=pmain["max_abs_err"], ms=ms, kernel_ms=ms,
                     plain_ms=plain_ms,
                     **bytes_bound(n_px * 20 + sm.numel() * 4),
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
    ms = cuda_ms(lambda: window_tap.sample_base_window(
        *targs, backend="cuda"), 20)
    plain_ms = cuda_ms(lambda: window_tap.sample_base_window(
        *targs, backend="torch"), 3)
    planes, uv = targs[0], targs[1]
    n_px = uv.shape[0] * uv.shape[1]
    rows.append(dict(name="bilinear_tap", route="cuda",
                     **KERNELS["bilinear_tap"],
                     launches=frame_launches["bilinear_tap"],
                     max_abs_err=tmain["max_abs_err"], ms=ms, kernel_ms=ms,
                     plain_ms=plain_ms,
                     **bytes_bound(n_px * (8 + 1 + 4 * planes.shape[0])
                                   + planes.numel() * 4),
                     # F.grid_sample is not the same addressing (it
                     # reflects or clamps where this repeats, then clamps
                     # at the edge): no library call computes this.
                     library_ms=None))
    emit("kernels", checks=checks)
    return rows


def phase_frame():
    """The main path: 2 warm-up + 8 timed 1080p frames of the demo scene
    through ``render_frame`` with moving time / light roll."""
    config = EngineConfig(width=1920, height=1080, tile_h=64, tile_w=32,
                          max_pairs=384 * 1024, max_pairs_shadow=256 * 1024,
                          point_light_kernel="unroll")
    t0 = time.time()
    scene, meta, world = build_demo_scene(config, grass=10000, rocks=65)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    check(scene.pair_pos.is_cuda, "scene is not on the card")
    warm, timed = 2, 8

    torch.cuda.reset_peak_memory_stats()
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
    launches = ops.kernel_launch_counts()
    for name, count in launches.items():
        check(count == warm + timed,
              f"kernel {name} launched {count} times in {warm + timed} "
              "frames, expected one per frame")

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

    # One more frame with the kernels' arguments noted, for phase 3.
    view = build_view_state(world, config, time=0.5, roll_light=0.6)
    with recorded_calls({}) as captured:
        render_frame(scene, view, meta, config)
    torch.cuda.synchronize()
    emit("frame", frame_ms=statistics.median(frame_ms),
         frame_ms_all=frame_ms, host_frame_ms=statistics.median(host_ms),
         frames=timed, warmup=warm, triangles=meta.num_triangles,
         instances=meta.num_instances,
         live_pairs={k: int(v) for k, v in aux["live_pairs"].items()},
         pair_overflow=int(aux["pair_overflow"]),
         covered_fraction=covered, sky_fraction=sky,
         shadow_factor_mean=float(sf.mean()),
         scene_build_s=round(build_s, 2),
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
         launches=launches)
    phase_profile(scene, meta, world, config)
    return captured, launches


def phase_profile(scene, meta, world, config) -> None:
    """Where one frame's device time goes: the ten device operations with
    the largest summed time (torch.profiler), beside the frame's total."""
    from torch.profiler import ProfilerActivity, profile

    view = build_view_state(world, config, time=0.7, roll_light=0.3)
    render_frame(scene, view, meta, config)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_frame(scene, view, meta, config)
        torch.cuda.synchronize()

    from torch.autograd import DeviceType

    def dev_us(evt):
        return float(getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)))

    # Device rows only: the host-side operator rows repeat their kernels'
    # time and would count it twice.
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in rows)
    emit("profile", device_busy_ms=total / 1e3,
         device_launches=sum(e.count for e in rows),
         top=[{"name": e.key[:70], "ms": dev_us(e) / 1e3, "calls": e.count}
              for e in rows[:10]])


def phase_frame_vs_plain() -> None:
    """One 256x256 frame through the kernels against the same frame
    through the plain versions, on the card."""
    config = TEST_CONFIG.replace(width=256, height=256, tile_h=16, tile_w=32,
                                 point_light_kernel="unroll", raster="cuda")
    scene, meta, world = build_demo_scene(config, grass=200, rocks=8)
    view = build_view_state(world, config, time=0.25, roll_light=0.1)
    img_k, aux_k = render_frame(scene, view, meta, config)
    img_p, aux_p = render_frame(scene, view, meta,
                                config.replace(raster="torch"))
    torch.cuda.synchronize()
    res = golden(img_k, img_p)
    sm_err = float((aux_k["shadowmap"] - aux_p["shadowmap"]).abs().max())
    check(sm_err <= 1e-6, f"shadow map max-abs {sm_err}")
    emit("frame_vs_plain", **res, shadowmap_max_abs_err=sm_err,
         tri_id_mismatches=int((aux_k["tri_id"] != aux_p["tri_id"]).sum()),
         covered_fraction=float((aux_k["tri_id"] >= 0).float().mean()))


def phase_engine() -> None:
    """The engine shell, the entry point behind ``python -m
    zeldaengine_tpu_torch.engine``: build the default demo world at 1080p,
    tick twice, check what it presents and that every tick went through
    the four kernels once."""
    engine = Engine(EngineConfig(width=1920, height=1080, frames_in_flight=1,
                                 present_mode="fifo",
                                 point_light_kernel="unroll"))
    ops.reset_kernel_launch_counts()
    frames = [engine.tick() for _ in range(2)]
    launches = ops.kernel_launch_counts()
    for name, count in launches.items():
        check(count == 2, f"engine: kernel {name} launched {count} times "
                          "in 2 ticks")
    for img in frames:
        check(img.dtype == np.uint8 and img.shape == (1080, 1920, 3),
              f"engine presented {img.dtype} {img.shape}")
    check(float(frames[-1].std()) > 5.0, "engine frame is flat")
    check(bool((frames[0] != frames[1]).any()), "the animation stands still")
    emit("engine", ticks=2, frame_ms=engine.stats.frame_ms,
         triangles=engine.stats.triangles, launches=launches,
         mean_level=float(frames[-1].mean()))


def main() -> None:
    t0 = time.time()
    info = phase_device()
    phase_build()
    captured, launches = phase_frame()
    rows = phase_kernels(captured, launches)
    phase_frame_vs_plain()
    phase_engine()
    emit("done", seconds=round(time.time() - t0, 1))
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
