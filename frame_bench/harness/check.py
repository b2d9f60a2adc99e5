"""The comparison that decides ``correct``: what the window's frames hold
against what the plain reference renders from the same inputs.

The reference (``reference/render.py``) renders in float64 and knows how
far a float32 evaluation of the raster can stray: the range each
shadow-map texel and each GBuffer depth may take, and the pixels whose
winning triangle no float32 rounding can change (``settled``). Each
sampled frame gives these numbers; a run reports the worst over its
samples, each beside its limit (``LIMITS``):

- ``shadow_off``: share of shadow-map texels outside their range (from
  every caster to the light-facing casters where the configuration states
  the light-apex cone cull);
- ``depth_off``: share of pixels whose GBuffer depth lies outside its
  range;
- ``ids_off``: share of the settled pixels on which the two triangle-id
  images do not partition the frame alike (compared as a partition, so
  the comparison does not depend on how either side numbers its
  triangles: the meshlet bake reorders them);
- ``pcf_off``, ``color_off``, ``present_off``: the resolve, on the
  settled pixels: the share of them whose PCF shadow factor differs by
  more than ``TOL["pcf"]``, and of the lit image's values (floats in
  [0, 1]) and of the presented uint8 frame's values (the ``Engine``
  cells) that differ by more than theirs;
- ``unmatched``: samples whose presented image is none of the last frames
  rendered, or whose frame shows no world that was pushed before it;
- ``dropped``: live triangles and pairs the program's caps dropped in the
  sampled frames (the reference drops none).

A configuration's file may name limits of its own (``check_limits``);
the others are ``LIMITS``.
"""

from __future__ import annotations

import torch

# Differences at or under these are rounding: depth outside its range by
# under two float32 units at 1.0, the PCF factor (its steps are 1/25), the
# lit image (a quarter of an 8-bit level) and the presented frame (one
# level, a rounding of the quarter).
TOL = {
    "depth": 1e-7,
    "pcf": 1e-4,
    "color": 1.0 / 1024.0,
    "present": 1.0,
}
# Each between the largest reading of sound runs of the program and the
# smallest of the control (the reference with its raster computed in
# bfloat16, ``control.py``) over the benchmark's cells, with more room
# above the first (PERF.md section 2). The counts are exact.
LIMITS = {
    "shadow_off": 1e-4,
    "depth_off": 1e-4,
    "ids_off": 1e-4,
    "pcf_off": 2e-3,
    "color_off": 2e-3,
    "present_off": 1e-3,
    "unmatched": 0,
    "dropped": 0,
}


def off_share(a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    """Share of elements of ``a`` more than ``tol`` from ``b`` (NaN counts,
    a shape that differs counts as all)."""
    if a.shape != b.shape:
        return 1.0
    close = (a.to(torch.float64) - b.to(torch.float64)).abs() <= tol
    return float((~close).sum()) / max(a.numel(), 1)


def outside_share(a: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  tol: float) -> float:
    """Share of elements of ``a`` outside [lo - tol, hi + tol]."""
    if a.shape != lo.shape:
        return 1.0
    a = a.to(torch.float64)
    inside = (a >= lo - tol) & (a <= hi + tol)
    return float((~inside).sum()) / max(a.numel(), 1)


def partition_off(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels on which id images ``a`` and ``b`` disagree as
    partitions of the frame: each id of one side is mapped to the id of
    the other that most of its pixels hold, and every pixel off that map
    counts; the larger of the two directions."""
    if a.shape != b.shape:
        return 1.0
    a = a.reshape(-1).to(torch.int64)
    b = b.reshape(-1).to(torch.int64)
    n = a.numel()
    if n == 0:
        return 0.0
    _, ia = torch.unique(a, return_inverse=True)
    _, ib = torch.unique(b, return_inverse=True)
    nb = int(ib.max()) + 1
    pairs, counts = torch.unique(ia * nb + ib, return_counts=True)
    pa, pb = pairs // nb, pairs % nb

    def agree(keys):
        best = torch.zeros(int(keys.max()) + 1, dtype=counts.dtype,
                           device=counts.device)
        best.scatter_reduce_(0, keys, counts, "amax")
        return int(best.sum())

    return (n - min(agree(pa), agree(pb))) / n


def frame_numbers(got: dict, ref: dict) -> dict:
    """The numbers of one sampled frame; ``got`` holds the program's
    tensors under the reference's keys (``u8`` only where presented)."""
    keep = ref["settled"].reshape(-1)

    def px(t):
        t = t.reshape(keep.shape[0], -1)
        return t[keep.to(t.device)]

    out = dict(
        shadow_off=outside_share(got["shadowmap"], ref["shadow_lo"],
                                 ref["shadow_hi"], TOL["depth"]),
        depth_off=outside_share(got["gbuffer_depth"], ref["depth_lo"],
                                ref["depth_hi"], TOL["depth"]),
        ids_off=partition_off(px(got["tri_id"]), px(ref["tri_id"])),
        pcf_off=off_share(px(got["shadow_factor"]), px(ref["shadow_factor"]),
                          TOL["pcf"]),
        color_off=off_share(px(got["color"]), px(ref["color"]),
                            TOL["color"]),
    )
    if "u8" in got:
        out["present_off"] = off_share(px(got["u8"]), px(ref["u8"]),
                                       TOL["present"])
    return out


def settled_share(ref: dict) -> float:
    """The share of a frame's pixels that ``ids_off`` and the resolve's
    numbers judge."""
    return float(ref["settled"].double().mean())


def worst(rows: list, extra: dict) -> dict:
    """The worst of each number over the sampled frames, with the
    run-level counts in ``extra``."""
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, 0.0), v)
    out.update(extra)
    return out


def limits_of(cfg: dict) -> dict:
    """``LIMITS`` with the configuration's own ``check_limits`` over them."""
    return {**LIMITS, **cfg.get("check_limits", {})}


def judge(numbers: dict, limits: dict = LIMITS) -> tuple:
    """(correct, [(name, value, limit)]) in ``limits`` order."""
    lines = [(k, numbers[k], limits[k]) for k in limits if k in numbers]
    ok = all(v <= lim for _, v, lim in lines)
    return ok, lines
