"""gather_probe CLI - the dynamic-gather probe of the JAX package's
``tools/pallas_gather_probe.py``, on the card.

Kernel ``gather_probe`` (``csrc/gather_probe.cu``) sums K scrambled
gathers an element over (8, 128) tiles of a table:

  * axis 1, "lane":    out[s, l] = sum_k t[s, p_k(idx[s, l])]  (128-way)
  * axis 0, "sublane": out[s, l] = sum_k t[p_k(idx[s, l]), l]  (8-way)

inside each tile, with p_k(i) = (i * (2k + 1) + k) mod D. On the card the
gathers are shared-memory loads (the TPU kernel's are vector-register
selects): the probe measures the rate a PCF kernel that keeps its map in
fast memory is bounded by.

    python -m zeldaengine_tpu_torch.tools.gather_probe [--blocks 4096] \\
        [--reps 20] [--seed 0] [--device cuda|cpu]

prints one JSON line: for each axis and K in (1, 8, 32, 128), the time of
one launch over ``--blocks`` tiles (``ms``, CUDA events around ``--reps``
launches after one warm-up) and, as the JAX tool prints them, ns a gather
op (one tile's K-th gather), ps an element and Gelem/s. With
``--device cpu`` the plain PyTorch version runs, timed on the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from zeldaengine_tpu_torch.ops import KERNEL_WRAPPERS, _build
from zeldaengine_tpu_torch.ops.rasterize_cuda import _check, _use_kernel
from zeldaengine_tpu_torch.utils.device import require_device

TILE = (8, 128)
AXES = {1: "lane", 0: "sublane"}
K_OPS = (1, 8, 32, 128)


def gather_dim(axis: int) -> int:
    """The gather's way count: 128 lanes (axis 1) or 8 rows (axis 0)."""
    if axis not in AXES:
        raise ValueError(f"axis must be 1 (lane) or 0 (sublane), got {axis}")
    return TILE[1] if axis == 1 else TILE[0]


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
    the card go to kernel ``gather_probe``, CPU tensors (or
    ``backend="torch"``) to ``gather_probe_plain``."""
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
    out = torch.empty_like(t)
    n_tiles = t.shape[0] // TILE[0]
    if n_tiles == 0:
        return out
    with torch.cuda.device(dev):
        code = _build.load().zk_gather_probe(
            t_ptr, i_ptr, out.data_ptr(), n_tiles, axis, k_ops,
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
    """One row a (axis, K): the mean time of a launch over ``n_blocks``
    tiles and the JAX tool's rates."""
    dev = require_device(device)
    rows = []
    for axis in AXES:
        t, idx = probe_inputs(n_blocks, axis, seed, dev)
        for k in K_OPS:
            ms = time_ms(lambda: gather_probe(t, idx, k, axis), reps, dev)
            ops = n_blocks * k  # one op: one tile's gather
            elems = ops * TILE[0] * TILE[1]
            rows.append(dict(
                axis=axis, name=AXES[axis], k=k, ms=ms,
                ns_per_gather_op=ms * 1e6 / ops,
                ps_per_elem=ms * 1e9 / elems,
                gelem_per_s=elems / (ms * 1e-3) / 1e9))
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
    print(json.dumps({
        "probe": "gather", "blocks": args.blocks, "reps": args.reps,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu (plain PyTorch, host clock)"),
        "results": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
