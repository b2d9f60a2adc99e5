"""Brute-force triangle rasterization in float64, with the reach of float32
rounding: every pixel centre of each triangle's bounding box is tested
against the triangle, and the nearest triangle wins each pixel.

The semantics are the engine's (the Vulkan rasterizer it replaces):

- a triangle's vertices are clip-space (x, y, z, w); in homogeneous pixel
  space (X, Y, w) = ((x + w) / 2 * width, (y + w) / 2 * height, w), and a
  pixel centre p = (px, py, 1) has c = M^-1 p, M the matrix whose columns
  are the three vertices. The pixel is covered where every c_i has the
  sign of det M (edges included) and not all are zero; its depth is
  sum(c_i z_i) (NDC z / w), and it is kept where that lies in [0, 1]. No
  near-plane clipping is needed: the test holds for any signs of w.
- front faces have det M < 0 (counter-clockwise in y-down pixels); a
  one-sided triangle is kept only when front-facing, a two-sided one when
  det M != 0; triangles with every w <= 0, or degenerate (|det M| no more
  than 1e-20 of the adjugate's largest entry), are dropped;
- the shadow pass's depth bias adds slope * max(|dz/dpx|, |dz/dpy|) +
  constant * 2^-23 to every depth of the triangle (vkCmdSetDepthBias);
- the nearest depth wins, ties to the lower triangle index; a pixel no
  triangle covers nearer than the clear depth 1.0 stays clear.

The configuration states float32, and these tests are ill-conditioned in
it: an edge value is a sum of terms of the size of the vertices' pixel
coordinates, while near a small triangle it is of the size of its area.
So each test also carries a forward bound on how far a float32
evaluation of the same formulas can stray (``ERR_ULPS`` units of float32
rounding on the terms' magnitudes, from vertex transform to depth). A
triangle covers a pixel surely where every edge value clears its bound,
possibly where none falls below minus it; ``bounds`` turns that into the
range each buffer element may take, and the pixels whose winner no
float32 rounding can change.

The bounding box of a triangle with every w > 1e-6 is its projected
vertices' box (with one pixel of margin); a triangle that crosses the
camera plane is tested over the whole buffer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

F64 = torch.float64
# Candidate (pixel, triangle) tests a chunk holds at once.
CHUNK_TESTS = 1 << 22
# float32's unit roundoff.
EPS32 = 2.0 ** -24
# Units of float32 rounding on the terms' magnitudes that bound a test's
# error. The bound adds every term's rounding at its worst; the program's
# float32 frames on the test scenes stay inside it down to 1/8 of a unit
# and leave it first at 1/16 (a sphere grid of sub-pixel triangles), so a
# quarter keeps four times that room.
ERR_ULPS = 0.25


class Setup(NamedTuple):
    """Per-triangle constants of one pass (float64, (T, ...))."""

    adj: torch.Tensor  # (T, 3, 3): row i = edge i's (A, B, C); u_i = A px + B py + C
    adj_abs: torch.Tensor  # (T, 3, 3): the same from the terms' magnitudes
    det: torch.Tensor  # (T,) det M = sum_i X_i A_i
    det_err: torch.Tensor  # (T,) bound on det's float32 error
    z: torch.Tensor  # (T, 3) clip z of the vertices
    z_abs: torch.Tensor  # (T, 3) their magnitudes' bound
    bias: torch.Tensor  # (T,) depth bias (0 without)
    bias_err: torch.Tensor  # (T,) bound on the bias's float32 error
    keep: torch.Tensor  # (T,) bool: kept exactly
    maybe: torch.Tensor  # (T,) bool: kept under some float32 rounding
    surely: torch.Tensor  # (T,) bool: kept under every float32 rounding
    bbox: torch.Tensor  # (T, 4) (x0, y0, x1, y1) in pixels, within the buffer
    width: int
    height: int
    low: bool = False

    @property
    def valid(self) -> torch.Tensor:
        return self.keep


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(F64)


def setup(clip: torch.Tensor, width: int, height: int, two_sided,
          valid: Optional[torch.Tensor] = None,
          depth_bias: Optional[tuple] = None,
          clip_abs: Optional[torch.Tensor] = None,
          low: bool = False) -> Setup:
    """The constants of triangles ``clip`` ((T, 3, 4) clip-space vertices)
    at a ``width`` x ``height`` buffer. ``two_sided``: a bool or a (T,)
    bool tensor; ``depth_bias``: (constant, slope) factors; ``clip_abs``:
    a bound on the vertices' terms' magnitudes (|matrix| @ |point|), by
    default |clip|; ``low``: every quantity rounded to bfloat16 as it is
    formed (the check's control)."""
    q = _bf16 if low else (lambda t: t)
    c = q(clip.to(F64))
    ca = c.abs() if clip_abs is None else clip_abs.to(F64)
    x, y, z, w = c.unbind(-1)
    xa, ya, za, wa = ca.unbind(-1)
    X = q((0.5 * x + 0.5 * w) * width)
    Y = q((0.5 * y + 0.5 * w) * height)
    Xa = (0.5 * xa + 0.5 * wa) * width
    Ya = (0.5 * ya + 0.5 * wa) * height
    a, b = [1, 2, 0], [2, 0, 1]
    A = q(Y[:, a] * w[:, b] - Y[:, b] * w[:, a])
    B = q(X[:, b] * w[:, a] - X[:, a] * w[:, b])
    C = q(X[:, a] * Y[:, b] - X[:, b] * Y[:, a])
    adj = torch.stack([A, B, C], -1)
    adj_abs = torch.stack([Ya[:, a] * wa[:, b] + Ya[:, b] * wa[:, a],
                           Xa[:, b] * wa[:, a] + Xa[:, a] * wa[:, b],
                           Xa[:, a] * Ya[:, b] + Xa[:, b] * Ya[:, a]], -1)
    det = q((X * A).sum(-1))
    det_err = ERR_ULPS * EPS32 * (Xa * adj_abs[..., 0]).sum(-1)
    scale = adj.abs().amax((-2, -1))
    two = torch.as_tensor(two_sided, dtype=torch.bool,
                          device=det.device).expand(det.shape)
    alive = (w > 0).any(-1)
    if valid is not None:
        alive &= valid
    keep = alive & (det.abs() > 1e-20 * scale) \
        & torch.where(two, det != 0, det < 0)
    maybe = alive & torch.where(two, det.abs() + det_err > 0,
                                det < det_err)
    surely = alive & (det.abs() > 1e-20 * scale + det_err) \
        & torch.where(two, det != 0, det < -det_err)
    safe = torch.where(det != 0, det, torch.ones_like(det))
    bias = torch.zeros_like(det)
    bias_err = torch.zeros_like(det)
    if depth_bias is not None:
        const_f, slope_f = depth_bias
        gx = (A * z).sum(-1) / safe
        gy = (B * z).sum(-1) / safe
        bias = q(slope_f * torch.maximum(gx.abs(), gy.abs())
                 + const_f * 2.0 ** -23)
        rel = det_err / safe.abs()
        ex = ERR_ULPS * EPS32 * ((adj_abs[..., 0] + A.abs()) * za).sum(-1) \
            / safe.abs() + gx.abs() * rel
        ey = ERR_ULPS * EPS32 * ((adj_abs[..., 1] + B.abs()) * za).sum(-1) \
            / safe.abs() + gy.abs() * rel
        bias_err = abs(slope_f) * torch.maximum(ex, ey) \
            + ERR_ULPS * EPS32 * bias.abs()
    w_ok = (w > 1e-6).all(-1)
    ws = torch.where(w_ok[:, None], w, torch.ones_like(w))
    sx, sy = X / ws, Y / ws
    full = torch.tensor([0.0, 0.0, float(width), float(height)], dtype=F64,
                        device=det.device)
    box = torch.stack([sx.amin(-1).clamp(0, width), sy.amin(-1).clamp(0, height),
                       sx.amax(-1).clamp(0, width), sy.amax(-1).clamp(0, height)],
                      -1)
    box = torch.where(w_ok[:, None], box, full)
    box = torch.where(maybe[:, None], box, torch.zeros_like(box))
    return Setup(adj, adj_abs, det, det_err, z, za, bias, bias_err, keep,
                 maybe, surely, box, int(width), int(height), low)


def _pixel_ranges(st: Setup):
    """Inclusive pixel index ranges (x_lo, x_hi, y_lo, y_hi) each triangle
    tests, and the count of its tests (0 for a dropped triangle)."""
    b = st.bbox

    def span(lo, hi, n):
        first = torch.clamp(torch.ceil(lo - 0.5) - 1, min=0)
        last = torch.clamp(torch.floor(hi - 0.5) + 1, max=n - 1)
        return first.long(), last.long()

    x0, x1 = span(b[:, 0], b[:, 2], st.width)
    y0, y1 = span(b[:, 1], b[:, 3], st.height)
    count = (x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)
    count = torch.where(st.maybe, count, torch.zeros_like(count))
    return x0, x1, y0, y1, count


def edge_values(st: Setup, tri: torch.Tensor, px: torch.Tensor,
                py: torch.Tensor) -> torch.Tensor:
    """u_i = A_i px + B_i py + C_i of triangles ``tri`` at (px, py): (N, 3)."""
    e = st.adj[tri]
    return e[..., 0] * px[:, None] + e[..., 1] * py[:, None] + e[..., 2]


class Tests(NamedTuple):
    """One chunk of (triangle, pixel) tests that some float32 rounding
    could cover."""

    tri: torch.Tensor  # (N,) triangle
    pix: torch.Tensor  # (N,) flat pixel index
    depth: torch.Tensor  # (N,) exact depth (bias included)
    err: torch.Tensor  # (N,) bound on the depth's float32 error
    exact: torch.Tensor  # (N,) bool: covered exactly
    sure: torch.Tensor  # (N,) bool: covered under every rounding


def _tests(st: Setup):
    """Chunks of the tests (``Tests``) that some rounding could cover."""
    x0, x1, y0, y1, count = _pixel_ranges(st)
    n_t = count.shape[0]
    if n_t == 0:
        return
    cum = torch.cumsum(count, 0)
    dev = count.device
    lo = 0
    while lo < n_t:
        before = int(cum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(cum, before + CHUNK_TESTS, right=True))
        hi = min(max(hi, lo + 1), n_t)
        cnt = count[lo:hi]
        n = int(cnt.sum())
        if n:
            tri = torch.repeat_interleave(
                torch.arange(lo, hi, device=dev), cnt)
            start = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
            off = torch.arange(n, device=dev) - start
            bw = (x1 - x0 + 1)[tri]
            ix = x0[tri] + off % bw
            iy = y0[tri] + off // bw
            fx, fy = ix.to(F64) + 0.5, iy.to(F64) + 0.5
            u = edge_values(st, tri, fx, fy)
            if st.low:
                u = _bf16(u)
            ea = st.adj_abs[tri]
            ue = ERR_ULPS * EPS32 * (ea[..., 0] * fx[:, None]
                                     + ea[..., 1] * fy[:, None] + ea[..., 2])
            det = st.det[tri]
            su = u * torch.sign(det)[:, None]
            depth = (u * st.z[tri]).sum(-1) / det + st.bias[tri]
            if st.low:
                depth = _bf16(depth)
            err = ((ue * st.z_abs[tri]).sum(-1)
                   + ERR_ULPS * EPS32 * (u.abs() * st.z_abs[tri]).sum(-1)
                   + (depth - st.bias[tri]).abs() * st.det_err[tri]) \
                / det.abs() + st.bias_err[tri]
            exact = (su >= 0).all(-1) & (su.sum(-1) > 0) & st.keep[tri] \
                & (depth >= 0) & (depth <= 1)
            maybe = (su >= -ue).all(-1) & (depth + err >= 0) \
                & (depth - err <= 1)
            sure = (su >= ue).all(-1) & st.surely[tri] & (depth - err >= 0) \
                & (depth + err <= 1)
            k = maybe | exact
            yield Tests(tri[k], (iy * st.width + ix)[k], depth[k], err[k],
                        exact[k], sure[k])
        lo = hi


def rasterize(st: Setup, ids: bool = True):
    """(depth (H, W) float64, clear 1.0; triangle ids (H, W) int64, -1
    where uncovered, or None without ``ids``)."""
    n_pix = st.width * st.height
    dev = st.det.device
    best = torch.ones(n_pix, dtype=F64, device=dev)
    best_id = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    for t in _tests(st):
        tri, pix, depth = t.tri[t.exact], t.pix[t.exact], t.depth[t.exact]
        near = torch.full((n_pix,), float("inf"), dtype=F64, device=dev)
        near.scatter_reduce_(0, pix, depth, "amin")
        better = near < best
        best = torch.where(better, near, best)
        if ids:
            win = depth == near[pix]
            first = torch.full((n_pix,), torch.iinfo(torch.int64).max,
                               dtype=torch.int64, device=dev)
            first.scatter_reduce_(0, pix[win], tri[win], "amin")
            best_id = torch.where(better, first, best_id)
    shape = (st.height, st.width)
    return best.reshape(shape), (best_id.reshape(shape) if ids else None)


def bounds(st: Setup, ids: Optional[torch.Tensor] = None,
           sure_st: Optional[Setup] = None):
    """What a float32 evaluation of the pass may write: (lo, hi, settled).
    ``lo`` and ``hi`` ((H, W) float64) bound each element's depth: the
    nearest possibly-covering triangle's least depth, and the nearest
    surely-covering one's greatest (or the clear 1.0). With ``ids`` (the
    exact winners), ``settled`` ((H, W) bool, else None) holds the pixels
    uncovered under every rounding, or with a winner that covers surely and
    lies surely nearer than every other triangle that may cover.
    ``sure_st``: the same triangles, with a narrower set kept surely (the
    light pass's cone cull keeps at least the light-facing casters)."""
    n_pix = st.width * st.height
    dev = st.det.device
    lo = torch.ones(n_pix, dtype=F64, device=dev)
    hi = torch.ones(n_pix, dtype=F64, device=dev)
    win = None if ids is None else ids.reshape(-1)
    rival = torch.full((n_pix,), float("inf"), dtype=F64, device=dev)
    win_hi = torch.full((n_pix,), float("inf"), dtype=F64, device=dev)
    seen = torch.zeros(n_pix, dtype=torch.bool, device=dev)
    for t in _tests(st):
        lo.scatter_reduce_(0, t.pix, t.depth - t.err, "amin")
        sure = t.sure
        if sure_st is not None:
            sure = sure & sure_st.surely[t.tri]
        hi.scatter_reduce_(0, t.pix[sure], (t.depth + t.err)[sure], "amin")
        if win is None:
            continue
        seen[t.pix] = True
        mine = t.tri == win[t.pix]
        other = ~mine
        rival.scatter_reduce_(0, t.pix[other], (t.depth - t.err)[other],
                              "amin")
        wk = mine & sure
        win_hi.scatter_reduce_(0, t.pix[wk], (t.depth + t.err)[wk], "amin")
    shape = (st.height, st.width)
    if win is None:
        return lo.reshape(shape), hi.reshape(shape), None
    settled = torch.where(win >= 0, win_hi < rival, ~seen)
    return lo.reshape(shape), hi.reshape(shape), settled.reshape(shape)
