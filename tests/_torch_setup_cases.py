"""Seeded clip-space triangles at the edges of ``triangle_setup``, shared by
tests/test_torch_triangle_setup.py (the port's plain version against the
JAX package's jitted setup) and chip_smoke.py (kernel ``triangle_setup``
against its plain version on the card). NumPy only."""

import numpy as np

WIDTH, HEIGHT = 1920, 1080


def _ordinary(rng, n, w=(0.5, 3.0)):
    # Triangles with positive w spread over the viewport (and past it).
    centers = rng.uniform(-1.2, 1.2, (n, 1, 3))
    pos = centers + rng.uniform(-0.2, 0.2, (n, 3, 3))
    ws = rng.uniform(*w, (n, 3, 1))
    z = rng.uniform(0.05, 0.95, (n, 3, 1)) * ws
    return np.concatenate([pos[..., :2] * ws, z, ws], -1).astype(np.float32)


def setup_edge_clips(seed: int = 21, n: int = 256) -> dict:
    """(T, 3, 4) float32 clip rows by case: zero-area and degenerate
    triangles, every w <= 0, w straddling +-1e-6, |det_scaled| near
    1e-20, padded zero rows (+0.0 and -0.0), very large coordinates and
    depths of +-0.0, each block beside ordinary triangles."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = {}

    c = _ordinary(rng, n)
    k = n // 4
    c[:k, 1] = c[:k, 0]                      # two vertices coincide
    c[k:2 * k, 1:] = c[k:2 * k, :1]          # all three coincide
    t = rng.uniform(-2.0, 2.0, (k, 1)).astype(f32)
    c[2 * k:3 * k, 2] = c[2 * k:3 * k, 0] + t * (c[2 * k:3 * k, 1]
                                                  - c[2 * k:3 * k, 0])
    c[3 * k:, :, 3] = c[3 * k:, :1, 3]       # collinear on screen, one w
    c[3 * k:, 2, :2] = (c[3 * k:, 0, :2] + c[3 * k:, 1, :2]) * f32(0.5)
    out["degenerate"] = c

    c = _ordinary(rng, n)
    c[..., 3] = rng.choice(f32([0.0, -0.0, -1e-7, -0.5, -3.0]), (n, 3))
    out["w_nonpositive"] = c

    c = _ordinary(rng, n)
    e = f32(1e-6)
    near = f32([e, np.nextafter(e, f32(1)), np.nextafter(e, f32(0)), -e,
                np.nextafter(-e, f32(-1)), np.nextafter(-e, f32(0)), 0.0,
                -0.0, 1.0, 2.0])
    c[..., 3] = rng.choice(near, (n, 3))
    out["w_near_1e-6"] = c

    # Thin triangles (the third vertex r edge lengths off the first edge)
    # scaled by s, w included: |det_scaled| goes as r * s and crosses
    # 1e-20.
    p0 = rng.uniform(-1.0, 1.0, (n, 2))
    p1 = p0 + rng.uniform(-0.5, 0.5, (n, 2))
    edge = p1 - p0
    r = 10.0 ** rng.uniform(-12.0, -8.0, (n, 1))
    p2 = p0 + rng.uniform(0.0, 1.0, (n, 1)) * edge + r * np.stack(
        [-edge[:, 1], edge[:, 0]], -1)
    w = rng.uniform(0.5, 2.0, (n, 3, 1))
    z = rng.uniform(0.1, 0.9, (n, 3, 1)) * w
    scale = 10.0 ** rng.uniform(-14.0, -12.0, (n, 1, 1))
    out["det_near_1e-20"] = (np.concatenate(
        [np.stack([p0, p1, p2], 1) * w, z, w], -1) * scale).astype(f32)

    c = _ordinary(rng, n)
    c[: n // 2] = 0.0
    c[n // 2: 3 * n // 4] = -0.0
    out["zero_rows"] = c

    c = _ordinary(rng, n)
    big = (10.0 ** rng.uniform(15.0, 30.0, (n, 3, 2))).astype(f32)
    c[..., :2] *= big * rng.choice(f32([-1.0, 1.0]), (n, 3, 2))
    c[n // 2:, :, 3] *= f32(1e20)
    out["huge"] = c

    c = _ordinary(rng, n)
    c[..., 2] = rng.choice(f32([0.0, -0.0, 0.5]), (n, 3)) * c[..., 3]
    out["signed_zero_depth"] = c
    return out


def two_sided_modes(n: int, seed: int = 22) -> dict:
    """``two_sided`` as a Python bool and as a (T,) mask."""
    mask = np.random.default_rng(seed).random(n) < 0.5
    return {"false": False, "true": True, "mask": mask}


def valid_mask(n: int, seed: int = 23) -> np.ndarray:
    return np.random.default_rng(seed).random(n) < 0.9
