"""gather_probe CLI - the dynamic-gather probe of the JAX package's
``tools/pallas_gather_probe.py``, on the card.

Kernel ``gather_probe`` (``csrc/gather_probe.cu``) sums K scrambled
gathers an element over (8, 128) tiles of a table:

  * axis 1, "lane":    out[s, l] = sum_k t[s, p_k(idx[s, l])]  (128-way)
  * axis 0, "sublane": out[s, l] = sum_k t[p_k(idx[s, l]), l]  (8-way)

inside each tile, with p_k(i) = (i * (2k + 1) + k) mod D. On the card the
gathers are shared-memory loads (the TPU kernel's are vector-register
selects): the probe measures the rate a PCF kernel that keeps its map in
fast memory is bounded by. The kernel stages the table in one of three
layouts (``LAYOUTS``): the sublane tile as it is; for the lane axis each
row as it is ("lane_shared": random words of a row share banks) below
``PRIVATE_MIN_K``, and from there four copies of each row, one in the
bank of each lane that owns elements of it ("lane_private": each thread
reads its own bank, one wavefront a warp load).

    python -m zeldaengine_tpu_torch.tools.gather_probe [--blocks 4096] \\
        [--reps 20] [--seed 0] [--device cuda|cpu]

prints one JSON line: for each axis and K in (1, 8, 32, 128), the layout,
the time of one launch over ``--blocks`` tiles (``ms``, CUDA events around
``--reps`` launches after one warm-up) and, as the JAX tool prints them,
ns a gather op (one tile's K-th gather), ps an element and Gelem/s; then
the launch's counts (``probe_counts``) and, on the card, its two bounds
(``probe_bounds``: bytes over 3.35 TB/s, conflict-free wavefronts over SMs
x the maximum SM clock) and the share of the larger one. With ``--device
cpu`` the plain PyTorch version runs, timed on the host clock, and the
bounds are None.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from zeldaengine_tpu_torch.ops import KERNEL_WRAPPERS, _build
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel
from zeldaengine_tpu_torch.utils.device import require_device

TILE = (8, 128)
AXES = {1: "lane", 0: "sublane"}
K_OPS = (1, 8, 32, 128)
# The kernel's layouts (``csrc/gather_probe.cu`` enum Layout) and the ones
# each axis can take.
LAYOUTS = {"sublane": 0, "lane_shared": 1, "lane_private": 2}
AXIS_LAYOUTS = {1: ("lane_shared", "lane_private"), 0: ("sublane",)}
# The lane axis takes the private layout from this K on: below it the
# copies' 16 store wavefronts a row cost more than the bank conflicts they
# remove (about 3 wavefronts a warp load instead of 1, 4 K a row). Set
# from the card's sweep (chip_smoke.py phase probes, ``crossover``: on an
# H100 the private layout is the faster from K 16 of 1, 2, 4, ... 128).
PRIVATE_MIN_K = 16
# Published HBM rate of one H100 SXM (NVIDIA data sheet).
PEAK_BYTES_PER_S = 3.35e12


def gather_dim(axis: int) -> int:
    """The gather's way count: 128 lanes (axis 1) or 8 rows (axis 0)."""
    if axis not in AXES:
        raise ValueError(f"axis must be 1 (lane) or 0 (sublane), got {axis}")
    return TILE[1] if axis == 1 else TILE[0]


def layout(axis: int, k_ops: int) -> str:
    """The layout kernel ``gather_probe`` stages the table in for this axis
    and K."""
    gather_dim(axis)
    if axis == 0:
        return "sublane"
    return "lane_private" if k_ops >= PRIVATE_MIN_K else "lane_shared"


def probe_counts(n_tiles: int, k_ops: int) -> dict:
    """One launch's work over ``n_tiles`` tiles: ``bytes`` (t and idx read
    once, out written once: 12 an element), ``gathers`` (K an element) and
    ``wavefronts`` (a warp's conflict-free load of 32 words is one)."""
    n = n_tiles * TILE[0] * TILE[1]
    return dict(elements=n, bytes=12 * n, gathers=k_ops * n,
                wavefronts=k_ops * n // 32)


def probe_bounds(counts: dict, sm_count: int, sm_clock_hz: float) -> dict:
    """The launch's two least times: its bytes over the HBM rate, its
    wavefronts over one a clock on each of ``sm_count`` multiprocessors at
    ``sm_clock_hz``; ``bound_by`` names the larger."""
    byte_ms = counts["bytes"] / PEAK_BYTES_PER_S * 1e3
    smem_ms = counts["wavefronts"] / (sm_count * sm_clock_hz) * 1e3
    return dict(byte_bound_ms=byte_ms, smem_bound_ms=smem_ms,
                bound_by="bytes" if byte_ms >= smem_ms else "shared memory")


def max_sm_clock_hz():
    """The first card's maximum SM clock by ``nvidia-smi`` (Hz), or None
    where nvidia-smi does not answer."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    run = subprocess.run(
        [exe, "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True)
    lines = run.stdout.split()
    if run.returncode != 0 or not lines:
        return None
    return float(lines[0]) * 1e6


def sass_loops(text: str) -> dict:
    """Each layout's gather loop in ``cuobjdump -sass`` output: of the
    innermost loops (backward branches with none inside) of its
    ``gather_probe_kernel`` function, the one with the most ``FADD``; its
    opcode counts (predicates and modifiers dropped), its instructions and
    those a gather (``LDS``). A template argument that is no layout (an
    older source's) keeps its number: ``gather_probe_kernel<128>``."""
    names = {v: k for k, v in LAYOUTS.items()}
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                      r"([^;]*);")
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(r"gather_probe_kernelILi(\d+)E", line)
            name = m and names.get(int(m.group(1)),
                                   f"gather_probe_kernel<{m.group(1)}>")
            cur = funcs.setdefault(name, []) if m else None
        elif cur is not None:
            m = insn.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(3).split(".")[0],
                            m.group(4)))
    out = {}
    for name, code in funcs.items():
        loops = []
        for addr, op, args in code:
            target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if target is not None and int(target.group(1), 16) <= addr:
                loops.append((int(target.group(1), 16), addr))
        best = None
        for lo, hi in loops:
            if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in loops):
                continue
            ops = collections.Counter(o for a, o, _ in code if lo <= a <= hi)
            if best is None or ops["FADD"] > best["FADD"]:
                best = ops
        if best:
            n, lds = sum(best.values()), best["LDS"]
            out[name] = dict(opcodes=dict(best), instructions=n, lds=lds,
                             fadd=best["FADD"],
                             per_gather=n / lds if lds else None)
    return out


def kernel_sass(binary: Path, keep=None) -> dict:
    """``sass_loops`` of a built library or object file (``cuobjdump``
    beside nvcc); ``keep``: a path to write the whole listing to."""
    exe = (shutil.which("cuobjdump")
           or str(Path(_build._nvcc()).parent / "cuobjdump"))
    dump = subprocess.run([exe, "-sass", str(binary)], capture_output=True,
                          text=True, check=True).stdout
    if keep:
        Path(keep).write_text(dump)
    return sass_loops(dump)


def probe_inputs(n_blocks: int, axis: int, seed: int = 0,
                 device="cpu") -> tuple:
    """The probe's table and indices for ``n_blocks`` tiles, from
    ``seed``: t uniform in [0, 1) (f32), idx uniform in [0, D) (i32)."""
    rng = np.random.default_rng(seed)
    shape = (n_blocks * TILE[0], TILE[1])
    t = rng.random(shape, dtype=np.float32)
    idx = rng.integers(0, gather_dim(axis), shape, dtype=np.int32)
    return (torch.from_numpy(t).to(device),
            torch.from_numpy(idx).to(device))


def gather_probe_plain(t: torch.Tensor, idx: torch.Tensor, k_ops: int,
                       axis: int) -> torch.Tensor:
    """Plain PyTorch version of ``gather_probe`` (any device): the K
    ``torch.gather`` calls, summed in k order from zero."""
    dim = gather_dim(axis)
    acc = torch.zeros_like(t)
    tiles = t.reshape(-1, *TILE)
    for k in range(k_ops):
        # int32 wraps as the kernel's unsigned arithmetic; & (D - 1) is the
        # floor modulo of a power of two.
        ik = ((idx * (2 * k + 1) + k) & (dim - 1)).long()
        if axis == 1:
            g = torch.gather(t, 1, ik)
        else:
            g = torch.gather(tiles, 1, ik.reshape(tiles.shape)).reshape(
                t.shape)
        acc = acc + g
    return acc


def gather_probe(t: torch.Tensor, idx: torch.Tensor, k_ops: int, axis: int,
                 backend: str = "auto") -> torch.Tensor:
    """T1's function on (n * 8, 128) f32 ``t`` and i32 ``idx``: tensors on
    the card go to kernel ``gather_probe`` in the layout ``layout(axis,
    k_ops)`` names, CPU tensors (or ``backend="torch"``) to
    ``gather_probe_plain``."""
    gather_dim(axis)
    if k_ops < 0:
        raise ValueError(f"k_ops must be >= 0, got {k_ops}")
    if not _use_kernel(t, backend):
        return gather_probe_plain(t, idx, k_ops, axis)
    if t.ndim != 2 or t.shape[1] != TILE[1] or t.shape[0] % TILE[0]:
        raise ValueError(f"t: expected (n * 8, 128), got {tuple(t.shape)}")
    dev = t.device
    t_ptr = _check(t, "t", torch.float32, dev=dev)
    i_ptr = _check(idx, "idx", torch.int32, t.shape, dev)
    if t_ptr % 16 or i_ptr % 16:
        raise ValueError("t and idx: the kernel's 16-byte loads need "
                         "16-byte aligned storage")
    out = torch.empty_like(t)
    n_tiles = t.shape[0] // TILE[0]
    if n_tiles == 0:
        return out
    with torch.cuda.device(dev):
        code = _build.load().zk_gather_probe(
            t_ptr, i_ptr, out.data_ptr(), n_tiles,
            LAYOUTS[layout(axis, k_ops)], k_ops,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "gather_probe")
    gather_probe.launches += 1
    return out


gather_probe.launches = 0
KERNEL_WRAPPERS["gather_probe"] = gather_probe


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Mean ms of one ``fn()`` after one warm-up call: CUDA events around
    ``reps`` calls on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def probe(n_blocks: int = 4096, reps: int = 20, seed: int = 0,
          device="cuda") -> list:
    """One row a (axis, K): the layout, the mean time of a launch over
    ``n_blocks`` tiles, the JAX tool's rates, the launch's counts and, on
    the card, its bounds and the share of the larger one (None on the
    CPU)."""
    dev = require_device(device)
    card = None
    if dev.type == "cuda":
        clock = max_sm_clock_hz()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        card = (sms, clock) if clock else None
    rows = []
    for axis in AXES:
        t, idx = probe_inputs(n_blocks, axis, seed, dev)
        for k in K_OPS:
            ms = time_ms(lambda: gather_probe(t, idx, k, axis), reps, dev)
            ops = n_blocks * k  # one op: one tile's gather
            elems = ops * TILE[0] * TILE[1]
            counts = probe_counts(n_blocks, k)
            bounds = dict(byte_bound_ms=None, smem_bound_ms=None,
                          bound_by=None, share=None)
            if card:
                bounds = probe_bounds(counts, *card)
                bounds["share"] = max(bounds["byte_bound_ms"],
                                      bounds["smem_bound_ms"]) / ms
            rows.append(dict(
                axis=axis, name=AXES[axis], k=k, layout=layout(axis, k),
                ms=ms, ns_per_gather_op=ms * 1e6 / ops,
                ps_per_elem=ms * 1e9 / elems,
                gelem_per_s=elems / (ms * 1e-3) / 1e9, **counts, **bounds))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gather_probe")
    parser.add_argument("--blocks", type=int, default=4096)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dev = require_device(args.device)
    rows = probe(args.blocks, args.reps, args.seed, dev)
    cuda = dev.type == "cuda"
    print(json.dumps({
        "probe": "gather", "blocks": args.blocks, "reps": args.reps,
        "device": (torch.cuda.get_device_name(dev) if cuda
                   else "cpu (plain PyTorch, host clock)"),
        "sm_count": (torch.cuda.get_device_properties(dev)
                     .multi_processor_count if cuda else None),
        "max_sm_clock_hz": max_sm_clock_hz() if cuda else None,
        "private_min_k": PRIVATE_MIN_K, "results": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
