"""Run one cell of the frame benchmark on the card and print its result.

    python3 frame_bench/run.py --workload demo1080.orbit --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``frame_bench/configs/``) and a traffic mix
(``frame_bench/traffic/``); ``--trace 1`` reports the per-layer metrics
(``frame_bench/metrics/``) instead of the end-to-end ones. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``;
``checked`` last: each number the check compared beside its limit); the
last lines of standard error repeat those numbers. Without as many cards
as the cell asks for, or with JAX or the JAX package loaded, it exits
with a non-zero code and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Every compile cache at a fixed path inside the checkout (the port's own
# nvcc and g++ builds go to zeldaengine_tpu_torch/_build/).
CACHE = BENCH_DIR / "_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[key] = str(CACHE / sub)
    sys.path[:] = [x for x in sys.path
                   if Path(x or ".").resolve() != BENCH_DIR]
    sys.path.insert(0, str(ROOT))

    import torch

    from frame_bench.harness import guard, spec
    from frame_bench.harness.cell import Run

    bench = spec.load_benchmark(ROOT)
    cell = spec.find_cell(bench, args.workload)
    spec.resolve(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"frame_bench: {args.workload} needs {cell['chips']} card(s);"
              f" torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = Run(bench, args.workload, args.seed, args.seconds,
              bool(args.trace), device="cuda", t_start=T_START)
    result = run.execute()
    found = guard.forbidden_loaded()
    if found:
        print(f"frame_bench: the run loaded {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, value, limit in run.check_lines:
        print(f"checked {name} = {value!r} (limit {limit!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
