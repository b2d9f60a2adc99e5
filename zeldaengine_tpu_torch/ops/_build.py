"""Build and load the package's CUDA kernels.

The sources under ``csrc/*.cu`` expose a plain C interface. At first use
they are compiled with nvcc for ``sm_90a`` (one nvcc process per source,
all started together, then one link step) into a shared library under
``zeldaengine_tpu_torch/_build/<hash of the sources and flags>/`` and
loaded with ctypes. Nothing is built at import time, and a failed build
or a missing compiler raises: there is no fallback.

FMA contraction is switched off (``-fmad=false``): the plain PyTorch
versions the kernels are held against run as separate multiply and add
ops, and a contracted edge function differs in the last ulp, which flips
coverage on pixels whose centre lies on an edge and flips PCF compares at
``tap ~= z``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
]

_LIB = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError(
            "zeldaengine_tpu_torch: nvcc not found; the CUDA kernels are "
            "built from csrc/*.cu at first use and need the CUDA toolkit")
    return exe


def _digest() -> str:
    h = hashlib.sha256()
    for p in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources (if this content was not built before) and
    return the path of the shared library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libzeldakernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"tmp{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs = []
    log = []
    failed = []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
        objs.append(str(obj))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + "\n" + "\n".join(log))
    tmp_lib = tmp / lib.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_lib), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout)
    os.replace(tmp_lib, lib)  # atomic: concurrent builds agree on content
    shutil.rmtree(tmp, ignore_errors=True)
    if verbose:
        print("\n".join(log))
    return lib


_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures (see the sources); every pointer and the stream is c_void_p.
_SIGNATURES = {
    # records, rec_w, starts, ends, sstarts, sends, gbounds, pair_tri,
    # init_depth, depth, tid, keys, height, width, tile_h, tile_w, n_sx,
    # super_h, super_w, sub_rows, y_row, y0_tiles, n_parts, min_chunks,
    # depth_only, z_row, eo_stride, skipped, stream
    "zk_pair_raster": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                       _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _VP, _VP],
    # records ... tid (as zk_pair_raster), attrs, height, width, tile_h,
    # tile_w, n_sx, super_h, super_w, sub_rows, y_row, y0_tiles,
    # texture_size, need_uv, has_combo, combo_const, z_row, eo_stride,
    # skipped, stream
    "zk_pair_raster_fused": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                             _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _F, _I, _I, _VP, _VP],
    # shadowmap, dim_y, dim_x, shadow_coord, out, height, width, radius,
    # scale, bias, stream
    "zk_pcf_taps": [_VP, _I, _I, _VP, _VP, _I, _I, _I, _F, _F, _VP],
    # planes, channels, size, uv, active, out, n_pixels, stream
    "zk_bilinear_tap": [_VP, _I, _I, _VP, _VP, _VP, _I, _VP],
    # acc, diffuse_color, n, p, v, roughness, ndotv, lights, tile_idx,
    # tile_cnt, k_max, height, width, block_h, out, stream
    "zk_point_lights": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                        _I, _I, _I, _I, _VP, _VP],
    # shadowmap, dim, shadow_coord, valid, out, origins_out, height, width,
    # tile_h, tile_w, threads, per_thread, win, pad_y, pad_x, py_dim,
    # px_dim, radius, scale, bias, stage_texels, stream
    "zk_pcf_window": [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _F, _F, _I, _VP],
    # shadowmap, dim_y, dim_x, lo_x, lo_y, w_y, out, stream
    "zk_pcf_window_table": [_VP, _I, _I, _I, _I, _I, _VP, _VP],
    "zk_pcf_window2d_table": [_VP, _I, _I, _I, _I, _I, _VP, _VP],
    # a, b, c, va, vb, vc, out, n, meta (host), stream
    "zk_fma": [_VP, _VP, _VP, _F, _F, _F, _VP, _I, _VP, _VP],
    # clip, two_sided, two_sided_all, valid_mask, n, width, height,
    # has_bias, slope_f, const_term, edge, zc, valid, bbox, zmin, stream
    "zk_triangle_setup": [_VP, _VP, _I, _VP, _I, _F, _F, _I, _F, _F, _VP,
                          _VP, _VP, _VP, _VP, _VP],
    # t, idx, out, n_tiles, layout, k_ops, stream
    "zk_gather_probe": [_VP, _VP, _VP, _I, _I, _I, _VP],
    # a, out, n, chains, n_ops, start (host floats), mult, add, stream
    "zk_fma_peak": [_VP, _VP, ctypes.c_longlong, _I, _I,
                    ctypes.POINTER(_F), _F, _F, _VP],
}


def load():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(code: int, name: str) -> None:
    """Raise when a launch was refused (the C function returns
    ``cudaGetLastError()``)."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
