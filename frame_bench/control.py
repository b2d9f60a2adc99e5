"""The check's control: the plain reference in bfloat16 put in the
program's place, compared with the reference by the run's own numbers.

    python3 frame_bench/control.py --workload demo1080.orbit \
        --seeds 11,12,13 [--device cuda] [--mode raster|vertex]

For each seed it renders the frames a run of that seed would sample (the
traffic's sample points over a nominal window; the orbit's or the pushes'
camera at them) twice, with the reference and with its raster computed in
bfloat16 (``reference/render.py``; ``--mode vertex``: only its vertices
rounded to bfloat16), and prints one JSON line: the worst of
each number over the frames, each beside its limit, and whether the check
refuses the control (it has to). Every limit of ``harness/check.py`` is set
between the sound runs' readings and these.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# The frames a nominal run of ``NOMINAL_SECONDS`` at ``NOMINAL_FPS`` issues;
# the control samples among them as a run does among its own.
NOMINAL_SECONDS = 20.0
NOMINAL_FPS = 40.0
# What the control rounds to bfloat16: "vertex", every clip-space vertex
# of both passes; "raster", besides, every quantity of the raster's
# setup and tests as it is formed.
CONTROL = "raster"


def control_numbers(bench: dict, cell_name: str, seed: int, device: str,
                    bench_dir=None, ref=None, mode: str = CONTROL) -> dict:
    from frame_bench.harness import check, spec
    from frame_bench.harness.cell import SAMPLES, WARM_FRAMES
    from frame_bench.harness.traffic import Traffic
    from frame_bench.reference.render import (
        Reference, orbit_positions, world_from_doc)

    bench_dir = bench_dir or spec.BENCH_DIR
    cell = spec.find_cell(bench, cell_name)
    cfg = spec.load_config(cell["config"], bench_dir)
    traffic = Traffic(spec.load_traffic(cell["traffic"], bench_dir), seed)
    ref = ref or Reference(cfg, device=device)
    frames = [WARM_FRAMES + int(p * NOMINAL_SECONDS * NOMINAL_FPS)
              for p in traffic.sample_points(SAMPLES)]
    rows = []
    for k in frames:
        t = k / NOMINAL_FPS
        doc = cfg["world"]
        if traffic.push_interval:
            cams = traffic.push_cameras(world_from_doc(doc).main_camera,
                                        int(t / traffic.push_interval) + 1)
            pos = cams[-1]
        else:
            first, step = traffic.frame_yaws()
            pos = orbit_positions(doc, first, step, k + 1)[k]
        got = ref.render(pos, doc, control=mode)
        want = ref.render(pos, doc, shadowmap=got["shadowmap"])
        if cfg["entry"] != "engine_tick":
            got.pop("u8")
        rows.append(check.frame_numbers(got, want))
    numbers = check.worst(rows, {})
    ok, lines = check.judge(numbers, check.limits_of(cfg))
    return dict(workload=cell_name, seed=seed, mode=mode, refused=not ok,
                checked={k: dict(value=v, limit=lim) for k, v, lim in lines})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--mode", default=CONTROL, choices=("raster", "vertex"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from frame_bench.harness import spec
    from frame_bench.reference.render import Reference

    bench = spec.load_benchmark(ROOT)
    cfg = spec.load_config(spec.find_cell(bench, args.workload)["config"])
    ref = Reference(cfg, device=args.device)
    ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control_numbers(bench, args.workload, seed, args.device,
                              ref=ref, mode=args.mode)
        ok = ok and out["refused"]
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
