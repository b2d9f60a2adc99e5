"""The reference's brute-force raster (``reference/raster.py``): exact
coverage and depth in float64, and ranges that hold a float32 evaluation
of the same formulas while a bfloat16 one leaves them."""

import pytest
import torch

from frame_bench.reference import raster

W, H = 64, 48


def _clip(points):
    """(T, 3, 4) clip rows of screen points (px, py, ndc depth) at w = 1."""
    p = torch.tensor(points, dtype=torch.float64)
    x = p[..., 0] / W * 2 - 1
    y = p[..., 1] / H * 2 - 1
    return torch.stack([x, y, p[..., 2], torch.ones_like(x)], -1)


def _scene(seed, n=300):
    """Seeded triangles in perspective: small and large, near and far."""
    g = torch.Generator().manual_seed(seed)
    centre = torch.rand(n, 1, 3, generator=g, dtype=torch.float64)
    centre = centre * torch.tensor([8.0, 6.0, 30.0], dtype=torch.float64) \
        + torch.tensor([-4.0, -3.0, 2.0], dtype=torch.float64)
    size = 10 ** (torch.rand(n, 1, 1, generator=g, dtype=torch.float64)
                  * 2.5 - 3)
    verts = centre + size * torch.randn(n, 3, 3, generator=g,
                                        dtype=torch.float64)
    near, far = 0.1, 100.0
    d = verts[..., 2]
    z = far / (far - near) * d - far * near / (far - near)
    return torch.stack([verts[..., 0], verts[..., 1], z, d], -1)


def _float32_raster(clip):
    """The homogeneous raster's formulas evaluated in float32."""
    c = clip.to(torch.float32)
    x, y, z, w = c.unbind(-1)
    X = (0.5 * x + 0.5 * w) * W
    Y = (0.5 * y + 0.5 * w) * H
    a, b = [1, 2, 0], [2, 0, 1]
    A = Y[:, a] * w[:, b] - Y[:, b] * w[:, a]
    B = X[:, b] * w[:, a] - X[:, a] * w[:, b]
    C = X[:, a] * Y[:, b] - X[:, b] * Y[:, a]
    det = (X * A).sum(-1)
    keep = (det != 0) & (w > 0).any(-1)
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32) + 0.5,
                            torch.arange(W, dtype=torch.float32) + 0.5,
                            indexing="ij")
    u = A[:, :, None, None] * px + B[:, :, None, None] * py \
        + C[:, :, None, None]
    su = u * torch.sign(det)[:, None, None, None]
    safe = torch.where(det != 0, det, torch.ones_like(det))
    depth = (u * z[:, :, None, None]).sum(1) / safe[:, None, None]
    cov = (su >= 0).all(1) & (su.sum(1) > 0) & keep[:, None, None] \
        & (depth >= 0) & (depth <= 1)
    depth = torch.where(cov, depth, torch.full_like(depth, 2.0))
    best, arg = depth.min(0)
    ids = torch.where(best <= 1, arg, torch.full_like(arg, -1))
    return torch.where(best <= 1, best, torch.ones_like(best)), ids


def test_a_known_triangle():
    st = raster.setup(_clip([[[4, 4, 0.5], [4, 20, 0.5], [20, 4, 0.5]]]),
                      W, H, two_sided=True)
    depth, ids = raster.rasterize(st)
    inside = (ids == 0)
    py, px = torch.meshgrid(torch.arange(H) + 0.5, torch.arange(W) + 0.5,
                            indexing="ij")
    want = (px >= 4) & (py >= 4) & (px + py <= 24)
    assert torch.equal(inside, want)
    assert torch.all(depth[inside] == 0.5)
    assert torch.all(depth[~inside] == 1.0)


def test_one_sided_keeps_front_faces():
    front = [[[4, 4, 0.5], [4, 20, 0.5], [20, 4, 0.5]]]
    back = [[[4, 4, 0.5], [20, 4, 0.5], [4, 20, 0.5]]]
    for tri, kept in ((front, True), (back, False)):
        st = raster.setup(_clip(tri), W, H, two_sided=False)
        assert bool(st.keep[0]) is kept


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bounds_hold_a_float32_raster(seed):
    clip = _scene(seed)
    st = raster.setup(clip, W, H, two_sided=True)
    depth, ids = raster.rasterize(st)
    lo, hi, settled = raster.bounds(st, ids)
    got, got_ids = _float32_raster(clip)
    got = got.to(torch.float64)
    assert torch.all((got >= lo - 1e-7) & (got <= hi + 1e-7))
    assert settled.double().mean() > 0.5
    assert torch.equal(got_ids[settled], ids[settled])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_bfloat16_raster_leaves_the_bounds(seed):
    clip = _scene(seed)
    st = raster.setup(clip, W, H, two_sided=True)
    lo, hi, _ = raster.bounds(st)
    low, _ = raster.rasterize(raster.setup(clip, W, H, two_sided=True,
                                           low=True))
    outside = (low < lo - 1e-7) | (low > hi + 1e-7)
    assert outside.double().mean() > 1e-3
