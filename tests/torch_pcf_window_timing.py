"""The windowed PCF backend (``pcf_backend="pallas"``) of two checkouts of
the port on the same inputs, and kernel ``pcf_window`` against variants of
its source, on one CUDA card:

    python3 tests/torch_pcf_window_timing.py --other DIR [--out FILE]
    python3 tests/torch_pcf_window_timing.py --variants [--out FILE]

Renders one 1080p frame of bench config 3 (``chip_smoke.config3``) with
``pcf_backend="pallas"`` through this checkout and keeps what the frame
gives the backend: the shadow map, the (1080, 1920, 4) shadow coordinate
and the valid mask. Then one process per run, alternately the checkout in
DIR and this one (other, this, this, other), builds that checkout's
kernels and runs its frame's ``pallas`` branch
(``passes/frame.py::_shadow_factor``, from the coordinate to the factor,
whatever padding and preparation the checkout does around its kernel):

- ``whole_ms``: device time of the branch, its calls replayed from a CUDA
  graph (``chip_smoke.graph_ms``);
- ``launches`` and ``device_busy_ms``: the device operations of one eager
  call and their summed device time (torch.profiler), the kernel's row
  beside them;
- ``kernel_ms``: the kernel alone from a CUDA graph (a checkout whose
  wrapper prepares the kernel's inputs in PyTorch: on inputs prepared
  once); with a shared-memory stage, also ``kernel_ms_direct_taps``, the
  kernel with the stage off;
- nvcc's register report for ``csrc/pcf_window.cu``;
- the factor and the window origins, compared between the checkouts.

With ``--variants``, on the same frame's inputs: the committed
``csrc/pcf_window.cu`` and the same source with one design choice undone
(``more_registers``: a launch bound of two 256-thread blocks, the
frame's block, so nvcc may take up to 128 registers a thread where the
committed bound of two 512-thread blocks keeps it at 64; ``ieee_division``:
the 25-tap quotient by a division; ``loads_one_by_one``: each pixel's
loads issued just before its arithmetic), each compiled with the
package's nvcc flags into a library of its own, held bit for bit (factor
and origins) against ``compute_pcf_pallas_plain``, and timed from a CUDA
graph in interleaved rounds, beside nvcc's register report.

Prints one JSON line per run or variant, then a summary, then the card's
name and power limit; everything goes to ``--out`` (default
``pcf_window_timing.json`` or ``pcf_window_variants.json``). Not
collected by pytest; needs a card and nvcc.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import types

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _frame_kw(config) -> dict:
    return dict(radius=config.pcf_radius, scale=config.pcf_scale,
                bias=config.shadow_bias, tile_h=config.tile_h,
                tile_w=config.tile_w, win=config.pcf_window)


def save_inputs(path: str) -> None:
    """One config-3 pallas frame through this checkout; keep the
    backend's inputs."""
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from zeldaengine_tpu_torch.passes import build_view_state, render_frame
    from zeldaengine_tpu_torch.passes import frame as fg
    from zeldaengine_tpu_torch.scene import build_demo_scene

    config = cs.config3().replace(pcf_backend="pallas")
    scene, meta, world = build_demo_scene(config, grass=10000, rocks=65)
    view = build_view_state(world, config, time=0.25, roll_light=0.4)
    with cs.recorded_calls({}) as captured:
        render_frame(scene, view, meta, config)
    (sm, sc), kw = captured["pcf_window"]
    torch.save({"sm": sm.cpu(), "sc": sc[:1080, :1920].contiguous().cpu(),
                "valid": kw["valid"][:1080, :1920].contiguous().cpu()}, path)


def worker(checkout: str, inputs: str, result: str) -> None:
    """Time one checkout's pallas branch on the saved inputs."""
    sys.path.insert(0, checkout)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from zeldaengine_tpu_torch.ops import _build, pcf_window
    from zeldaengine_tpu_torch.passes import frame as fg

    log = io.StringIO()
    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)  # build anew
    with contextlib.redirect_stdout(log):
        _build.build(verbose=True)
    _build.load()
    ptxas = log.getvalue().split("== pcf_window.cu")[1].split("== ")[0]
    d = torch.load(inputs)
    sm, sc, valid = d["sm"].cuda(), d["sc"].cuda(), d["valid"].cuda()
    config = cs.config3().replace(pcf_backend="pallas")
    fg.compute_shadow_coord = lambda *_: sc
    view = types.SimpleNamespace(shadow_space=None)

    def branch():
        return fg._shadow_factor(sm, None, view, config, valid=valid)

    kw = _frame_kw(config)
    out = {"checkout": checkout, "ptxas": ptxas.strip().splitlines()}
    if hasattr(pcf_window, "pcf_window_taps"):
        # The kernel on inputs its wrapper prepared in PyTorch (padded as
        # the frame pads them).
        h, w = sc.shape[:2]
        ph = -(-h // config.tile_h) * config.tile_h
        scp = torch.nn.functional.pad(sc, (0, 0, 0, 0, 0, ph - h))
        vp = torch.nn.functional.pad(valid, (0, 0, 0, ph - h))
        inp, win = pcf_window.pcf_window_inputs(
            sm, scp, kw["radius"], kw["scale"], kw["bias"], kw["tile_h"],
            kw["tile_w"], kw["win"], vp)
        origins = inp.origins
        kernel = lambda: pcf_window.pcf_window_taps(  # noqa: E731
            inp, kw["radius"], kw["scale"], kw["tile_h"], kw["tile_w"], win,
            backend="cuda")
    else:
        origins = pcf_window.compute_pcf_pallas(
            sm, sc, valid=valid, backend="cuda", return_origins=True,
            **kw)[1]
        kernel = lambda: pcf_window.compute_pcf_pallas(  # noqa: E731
            sm, sc, valid=valid, backend="cuda", **kw)
    out["kernel_ms"] = cs.graph_ms(kernel, 20)
    if hasattr(pcf_window, "STAGE_TEXELS"):
        saved = pcf_window.STAGE_TEXELS
        pcf_window.STAGE_TEXELS = 0
        out["kernel_ms_direct_taps"] = cs.graph_ms(kernel, 20)
        pcf_window.STAGE_TEXELS = saved
        out["kernel_ms_again"] = cs.graph_ms(kernel, 20)
    out["whole_ms"] = cs.graph_ms(branch, 20)
    branch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        branch()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))) / 1e3

    out["launches"] = sum(e.count for e in rows)
    out["device_busy_ms"] = sum(dev_ms(e) for e in rows)
    out["profile"] = sorted(
        ({"name": e.key[:70], "ms": dev_ms(e), "calls": e.count}
         for e in rows), key=lambda r: -r["ms"])
    factor = branch()
    torch.cuda.synchronize()
    torch.save({"factor": factor.cpu(), "origins": origins.cpu()},
               result + ".pt")
    with open(result, "w") as f:
        json.dump(out, f)


VARIANTS = {
    "more_registers": ("__launch_bounds__(kMaxThreads, 2)",
                       "__launch_bounds__(256, 2)"),
    "ieee_division": ("if (N * N == 25) {", "if (false) {"),
    "loads_one_by_one": ("constexpr int kBatch = 4;",
                         "constexpr int kBatch = 1;"),
}
ROUNDS = 5


def variants(out_path: str) -> None:
    """The committed kernel against its variants on one frame's inputs."""
    import ctypes
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from zeldaengine_tpu_torch.ops import _build, pcf_window

    work = tempfile.mkdtemp()
    inputs = os.path.join(work, "inputs.pt")
    save_inputs(inputs)
    d = torch.load(inputs)
    sm, sc, valid = d["sm"].cuda(), d["sc"].cuda(), d["valid"].cuda()
    config = cs.config3()
    kw = _frame_kw(config)
    want, want_org = pcf_window.compute_pcf_pallas_plain(
        sm, sc, valid=valid, return_origins=True, **kw)
    src = (_build.CSRC / "pcf_window.cu").read_text()
    sources = {"committed": src}
    for name, (a, b) in VARIANTS.items():
        if a not in src:
            raise RuntimeError(f"pcf_window.cu no longer holds {a!r}")
        sources[name] = src.replace(a, b)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(work, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             cu, "-o", os.path.join(work, name + ".so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    h, w = sc.shape[:2]
    geo = pcf_window.window_geometry(sm.shape[-1], kw["radius"], kw["scale"],
                                     kw["win"])
    threads, per = pcf_window.tile_threads(kw["tile_h"], kw["tile_w"])
    out = torch.empty((h, w), device="cuda")
    org = torch.empty_like(want_org)
    calls, report = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}\n{log}")
        fn = ctypes.CDLL(os.path.join(work, name + ".so")).zk_pcf_window
        fn.argtypes = _build._SIGNATURES["zk_pcf_window"]
        fn.restype = ctypes.c_int

        def call(fn=fn):
            code = fn(sm.data_ptr(), sm.shape[-1], sc.data_ptr(),
                      valid.data_ptr(), out.data_ptr(), org.data_ptr(), h, w,
                      kw["tile_h"], kw["tile_w"], threads, per, geo.win,
                      geo.pad_y, geo.pad_x, geo.py_dim, geo.px_dim,
                      kw["radius"], kw["scale"], kw["bias"],
                      pcf_window.STAGE_TEXELS,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"{name}: launch refused, cudaError {code}")
        call()
        torch.cuda.synchronize()
        report[name] = {
            "equal": bool(torch.equal(out, want)),
            "origins_equal": bool(torch.equal(org, want_org)),
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]}
        cs.check(report[name]["equal"] and report[name]["origins_equal"],
                 f"variant {name} differs from the plain version")
        print(json.dumps({"variant": name, **report[name]}), flush=True)
        calls[name] = call
    times = {name: [] for name in calls}
    for _ in range(ROUNDS):
        for name, call in calls.items():
            times[name].append(cs.graph_ms(call, 20))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    summary = {"rounds": ROUNDS, "ms": times, "device": smi,
               "median_ms": {k: statistics.median(v)
                             for k, v in times.items()}}
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"variants": report, "summary": summary}, f, indent=1)
    print(smi, flush=True)


def main(other: str, out_path: str) -> None:
    import torch

    work = tempfile.mkdtemp()
    inputs = os.path.join(work, "inputs.pt")
    save_inputs(inputs)
    runs = []
    for i, checkout in enumerate((other, HERE, HERE, other)):
        res = os.path.join(work, f"run{i}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", checkout, "--inputs", inputs,
                        "--result", res], check=True)
        with open(res) as f:
            r = json.load(f)
        r["which"] = "other" if checkout == other else "this"
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("profile", "ptxas")}), flush=True)
        runs.append((r, torch.load(res + ".pt")))
    a, b = runs[0][1], runs[1][1]
    diff = (a["factor"] - b["factor"]).abs()
    moved = (a["origins"] != b["origins"]).any(-1).nonzero().tolist()
    summary = {
        name: {k: [r[k] for r, _ in runs if r["which"] == name]
               for k in ("kernel_ms", "kernel_ms_direct_taps",
                         "kernel_ms_again", "whole_ms", "launches",
                         "device_busy_ms") if k in runs[0 if name == "other"
                                                       else 1][0]}
        for name in ("other", "this")}
    summary["factor_pixels_differing"] = int((diff > 0).sum())
    summary["factor_max_abs_diff"] = float(diff.max())
    summary["tiles_whose_origin_moved"] = [
        {"tile": t, "other": a["origins"][t[0], t[1]].tolist(),
         "this": b["origins"][t[0], t[1]].tolist()} for t in moved]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    summary["device"] = smi
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"runs": [r for r, _ in runs], "summary": summary}, f,
                  indent=1)
    print(smi, flush=True)
    print("median whole_ms", {k: statistics.median(v["whole_ms"])
                              for k, v in summary.items()
                              if isinstance(v, dict)}, flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="checkout to compare with")
    ap.add_argument("--variants", action="store_true",
                    help="time the kernel against variants of its source")
    ap.add_argument("--out")
    ap.add_argument("--worker")
    ap.add_argument("--inputs")
    ap.add_argument("--result")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.inputs, args.result)
    elif args.variants:
        variants(args.out or "pcf_window_variants.json")
    else:
        main(args.other, args.out or "pcf_window_timing.json")
