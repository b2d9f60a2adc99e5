"""Kernel ``pcf_taps`` (``zeldaengine_tpu_torch/csrc/pcf_taps.cu``) against
two variants of it on the config-3 frame's PCF inputs, on one CUDA card:

    python3 tests/torch_pcf_taps_variants.py

- ``committed``: the source as the package builds it;
- ``no_window``: the same source with the shared-memory window switched
  off, so every block takes the window kernel's direct taps (its indices
  hoisted, each tap through the read-only path);
- ``max_radius_4`` / ``max_radius_8``: one kernel for every radius up to a
  compile-time maximum, its tap loops unrolled to that maximum and left at
  the run-time radius, indices hoisted as in the window kernel, no window.

Each variant is compiled with the package's nvcc flags into a library of
its own, held bit for bit against ``compute_pcf_plain`` on the frame's
inputs and on a ragged 37x53 coordinate field at radius 0-4, and timed as
``chip_smoke.py`` times kernels (``graph_ms``: device time of calls
replayed from a CUDA graph) in interleaved rounds. Prints one JSON line per
check, then the times, then the card's name and power limit; the full
log, nvcc's register report included, goes to the file named by ``--log``
(default ``pcf_taps_variants.log``). Not collected by pytest; needs a card
and nvcc.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zeldaengine_tpu_torch.ops import _build, pcf_cuda  # noqa: E402

SOURCE = _build.CSRC / "pcf_taps.cu"
ROUNDS = 7

# The variant with a compile-time maximum radius, inserted into the
# committed source (it shares load_pixel, wrap and wrap_from).
MAX_RADIUS_KERNEL = r"""
template <int MAXR>
__global__ void __launch_bounds__(kThreads) pcf_taps_max_radius_kernel(
    const float* __restrict__ sm, int dim_y, int dim_x,
    const float4* __restrict__ coord, float* __restrict__ out, int height,
    int width, int radius, float scale, float bias) {
  constexpr int kMaxN = 2 * MAXR + 1;
  const int n = 2 * radius + 1;
#pragma unroll
  for (int j = 0; j < kNP; ++j) {
    const Pixel p = load_pixel(coord, height, width, dim_y, dim_x, bias, j);
    if (!p.inside) continue;
    if (!p.in_range) {
      out[p.i] = 1.0f;
      continue;
    }
    const int ix0 = (int)floorf(p.fx + scale * (float)(-radius));
    const int iy0 = (int)floorf(p.fy + scale * (float)(-radius));
    const int wx0 = wrap(ix0, dim_x), wy0 = wrap(iy0, dim_y);
    int wx[kMaxN];
#pragma unroll
    for (int k = 0; k < kMaxN; ++k) {
      if (k == n) break;
      wx[k] = wrap_from(wx0, ix0,
                        (int)floorf(p.fx + scale * (float)(k - radius)),
                        dim_x);
    }
    float total = 0.0f;
#pragma unroll
    for (int ky = 0; ky < kMaxN; ++ky) {
      if (ky == n) break;
      const int iy = (int)floorf(p.fy + scale * (float)(ky - radius));
      const float* row = sm + (size_t)wrap_from(wy0, iy0, iy, dim_y) * dim_x;
#pragma unroll
      for (int kx = 0; kx < kMaxN; ++kx) {
        if (kx == n) break;
        total = total + (__ldg(row + wx[kx]) < p.z_cmp ? 0.1f : 1.0f);
      }
    }
    out[p.i] = total / (float)(n * n);
  }
}

"""
DISPATCH = """  if (radius == kWindowRadius)
    pcf_taps_window_kernel<kWindowRadius><<<grid, kThreads, 0, s>>>(
        smf, dim_y, dim_x, sc, o, height, width, scale, bias);
  else
    pcf_taps_direct_kernel<<<grid, kThreads, 0, s>>>(
        smf, dim_y, dim_x, sc, o, height, width, radius, scale, bias);
"""
WINDOW_TEST = "const bool use_win =\n      bx0 != INT_MAX"


def variant_sources() -> dict:
    src = SOURCE.read_text()
    for piece in (DISPATCH, WINDOW_TEST, "}  // namespace"):
        if piece not in src:
            raise RuntimeError(f"pcf_taps.cu no longer holds {piece!r}")
    out = {"committed": src,
           "no_window": src.replace(WINDOW_TEST,
                                    "const bool use_win = false &&\n"
                                    "      bx0 != INT_MAX")}
    for max_r in (4, 8):
        v = src.replace("}  // namespace", MAX_RADIUS_KERNEL
                        + "}  // namespace")
        out[f"max_radius_{max_r}"] = v.replace(DISPATCH, f"""\
  if (radius > {max_r}) return (int)cudaErrorInvalidValue;
  pcf_taps_max_radius_kernel<{max_r}><<<grid, kThreads, 0, s>>>(
      smf, dim_y, dim_x, sc, o, height, width, radius, scale, bias);
""")
    return out


def build_all(work: Path, log) -> dict:
    """Compile every variant (one nvcc each, all started together)."""
    procs = {}
    for name, text in variant_sources().items():
        src = work / f"{name}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(_build.CSRC), "-shared", str(src), "-o",
               str(work / f"{name}.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        print(f"== {name}\n{out}", file=log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}\n{out}")
        fn = ctypes.CDLL(str(work / f"{name}.so")).zk_pcf_taps
        fn.argtypes = _build._SIGNATURES["zk_pcf_taps"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def launcher(fn, smap, coord, out, radius, scale, bias):
    def call():
        code = fn(smap.data_ptr(), smap.shape[0], smap.shape[1],
                  coord.data_ptr(), out.data_ptr(), coord.shape[0],
                  coord.shape[1], radius, scale, bias,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch refused: cudaError {code}")
    return call


def main(log) -> None:
    cs.phase_device()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp), log)
        _, _, _, _, captured, _ = cs.phase_frame()
        (sm, sc), pkw = captured["pcf_taps"]
        radius, scale, bias = pkw["radius"], pkw["scale"], pkw["bias"]
        rng = np.random.default_rng(7)
        wild = torch.from_numpy(np.concatenate(
            [rng.uniform(-1.5, 2.5, (37, 53, 2)),
             rng.uniform(-0.2, 1.2, (37, 53, 1)),
             rng.uniform(-0.5, 2.0, (37, 53, 1))], -1).astype(
                 np.float32)).cuda()
        sm_small = torch.from_numpy(
            rng.random((96, 160)).astype(np.float32)).cuda()
        cases = [("frame", sm, sc, radius, scale, bias)] + [
            (f"ragged 37x53, radius {r}", sm_small, wild, r, 1.5, 0.01)
            for r in range(5)]
        for name, fn in libs.items():
            res = {}
            for label, smap, coord, r, sc_, b in cases:
                want = pcf_cuda.compute_pcf_plain(smap, coord, radius=r,
                                                  scale=sc_, bias=b)
                got = torch.empty_like(want)
                launcher(fn, smap, coord, got, r, sc_, b)()
                torch.cuda.synchronize()
                res[label] = int((got.view(torch.int32)
                                  != want.view(torch.int32)).sum())
            cs.check(not any(res.values()), f"{name} differs: {res}")
            cs.emit("pcf_taps_variant_check", variant=name,
                    bit_mismatches=res)
        out = torch.empty(sc.shape[:2], dtype=torch.float32, device="cuda")
        times = {name: [] for name in libs}
        for _ in range(ROUNDS):
            for name, fn in libs.items():
                times[name].append(cs.graph_ms(
                    launcher(fn, sm, sc, out, radius, scale, bias), 20))
    cs.emit("pcf_taps_variants", rounds=ROUNDS, ms=times,
            median_ms={k: statistics.median(v) for k, v in times.items()},
            min_ms={k: min(v) for k, v in times.items()},
            max_ms={k: max(v) for k, v in times.items()})


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", default="pcf_taps_variants.log")
    log_path = ap.parse_args().log
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    with open(log_path, "w") as log_file:
        real = sys.stdout
        sys.stdout = log_file
        try:
            main(log_file)
        finally:
            sys.stdout = real
    with open(log_path) as f:
        for line in f:
            if line.startswith('{"phase": "pcf_taps_variant'):
                print(line.rstrip())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
