"""Frames of two checkouts of the port on one CUDA card, in alternating
processes (other, this, this, other; ``--rounds`` times):

    python3 tests/torch_frame_ab_timing.py --other DIR [--configs 3,4,1]
        [--rounds N] [--host-profile] [--out FILE]

Each process builds its checkout's kernels (``chip_smoke.phase_build``)
and, for each bench config (3: the 1080p demo frame, ``chip_smoke.config3``;
4: the meshlet frame, ``config4``; 1: the forward sphere, ``config1``),
renders 2 warm-up + 8 timed frames through that checkout's
``chip_smoke.timed_frames`` (``frame_ms`` and ``host_frame_ms``: medians;
the kernels' launch counts), profiles one more frame (``device_busy_ms``
and ``device_launches``: torch.profiler, ``chip_smoke.device_profile``) and
keeps its last image. The two checkouts' images are compared bit for bit.
With ``--host-profile``, 5 more frames under cProfile (each config's 15
functions with the most own time: calls, own and cumulative ms a frame;
cProfile slows Python, so compare these only between the checkouts).

Prints one JSON line per process, then a summary (over each checkout's
processes: the median of their medians, their range, and in how many of
the rounds' two pairs this checkout's frame_ms was the lower), then the
card's name and power limit; everything
goes to ``--out`` (default ``frame_ab_timing.json``). Not collected by
pytest; needs a card and nvcc.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def host_profile(fn, frames: int = 5) -> list:
    """The 15 functions with the most own time over ``frames`` calls of
    ``fn`` under cProfile: [name, calls, own ms, cumulative ms] a call."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(frames):
        fn()
    prof.disable()
    rows = [[f"{os.path.basename(f)}:{line}:{name}", nc / frames,
             tt * 1e3 / frames, ct * 1e3 / frames]
            for (f, line, name), (_, nc, tt, ct, _) in
            pstats.Stats(prof).stats.items()]
    return sorted(rows, key=lambda r: -r[2])[:15]


def child(root: str, configs: list, image_dir: str, tag: str,
          profile: bool) -> None:
    """One process: ``root``'s kernels and frames."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke as cs

    cs.phase_build()
    out = {"checkout": root}
    for c in configs:
        if c == "3":
            config = cs.config3()
            scene, meta, world = cs.build_demo_scene(config, grass=10000,
                                                     rocks=65)
        elif c == "4":
            config = cs.config4()
            scene, meta, world, _ = cs.config4_scene(config)
        elif c == "1":
            config = cs.config1()
            scene, meta, world = cs.forward_scene(config)
        else:
            raise ValueError(f"unknown config {c!r}")
        frame_ms, host_ms, image, _, launches = cs.timed_frames(
            scene, meta, world, config, 2, 8)
        np.save(os.path.join(image_dir, f"{tag}_{c}.npy"),
                image.cpu().numpy())
        view = cs.build_view_state(world, config, time=0.5, roll_light=0.6)
        busy = cs.device_profile(
            lambda: cs.render_frame(scene, view, meta, config),
            f"ab_config{c}")
        out[c] = dict(frame_ms=statistics.median(frame_ms),
                      host_frame_ms=statistics.median(host_ms),
                      frame_ms_all=frame_ms,
                      device_busy_ms=busy["device_busy_ms"],
                      device_launches=busy["device_launches"],
                      kernel_launches=launches)
        if profile:
            def frame():
                cs.render_frame(scene, view, meta, config)
                torch.cuda.synchronize()
            out[c]["host_profile"] = host_profile(frame)
    print("RESULT " + json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--configs", default="3,4,1")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--host-profile", action="store_true")
    ap.add_argument("--out", default="frame_ab_timing.json")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--image-dir", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args()
    configs = args.configs.split(",")
    if args.child:
        child(args.child, configs, args.image_dir, args.tag,
              args.host_profile)
        return
    import numpy as np

    other = os.path.abspath(args.other)
    runs = []
    with tempfile.TemporaryDirectory() as image_dir:
        order = [("other", other), ("this", HERE), ("this", HERE),
                 ("other", other)] * args.rounds
        for i, (who, root) in enumerate(order):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--configs", args.configs, "--image-dir", image_dir,
                 "--tag", f"{who}{i}"]
                + (["--host-profile"] if args.host_profile else []),
                cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise SystemExit(f"run {i} ({who}) failed")
            res = json.loads([ln for ln in proc.stdout.splitlines()
                              if ln.startswith("RESULT ")][-1][7:])
            res.update(run=i, who=who)
            runs.append(res)
            print(json.dumps(res), flush=True)
        def image(r, c):
            return np.load(os.path.join(image_dir,
                                        f"{r['who']}{r['run']}_{c}.npy"))

        images_equal = {c: all(np.array_equal(image(runs[0], c), image(r, c))
                               for r in runs) for c in configs}
    summary = {}
    for c in configs:
        summary[c] = {
            who: {k: dict(median=statistics.median(vals), min=min(vals),
                          max=max(vals))
                  for k in ("frame_ms", "host_frame_ms", "device_busy_ms",
                            "device_launches")
                  for vals in [[r[c][k] for r in runs if r["who"] == who]]}
            for who in ("other", "this")}
        # Each round runs two pairs, (other, this) and (this, other).
        lower = 0
        for i in range(0, len(runs), 2):
            a, b = runs[i], runs[i + 1]
            mine, theirs = (b, a) if a["who"] == "other" else (a, b)
            lower += mine[c]["frame_ms"] < theirs[c]["frame_ms"]
        summary[c]["pairs_this_lower"] = lower
        summary[c]["pairs"] = len(runs) // 2
        summary[c]["images_bit_for_bit"] = images_equal[c]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"summary": summary}), flush=True)
    print(smi, flush=True)
    with open(args.out, "w") as f:
        json.dump({"runs": runs, "summary": summary, "nvidia_smi": smi,
                   "other": other, "this": HERE}, f, indent=1)


if __name__ == "__main__":
    main()
