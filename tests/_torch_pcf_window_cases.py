"""The seeded shadow maps, coordinates and valid masks of the windowed-PCF
tests of the port (tests/test_torch_pcf_window*.py)."""

import numpy as np


DIM, H, W, TILE_H, TILE_W = 256, 32, 256, 32, 128


def _case(kind):
    rng = np.random.default_rng({"in_window": 1, "out_of_window": 2}[kind])
    sm = rng.random((DIM, DIM)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    if kind == "in_window":
        # Every tap of a tile inside one 128-column-aligned window.
        u = 0.55 + 0.0002 * xx + 0.0003 * yy
        v = 0.30 + 0.0015 * yy + 0.0001 * xx
        win, valid = 256, None
    else:
        # Footprints of ~200 texels per tile and a 128-texel window: the
        # taps clamp to the window edge; an uncovered tile falls back to
        # the plain mean of its coordinates.
        u = 0.1 + 0.0031 * xx - 0.002 * yy
        v = 0.2 + 0.012 * yy + 0.0007 * xx
        win = 128
        valid = rng.random((H, W)) < 0.8
        valid[:, TILE_W:] = False
    z = rng.random((H, W))
    sc = np.stack([u, v, z, np.ones((H, W))], -1).astype(np.float32)
    sc = sc * np.float32(1.25)
    return sm, sc, win, valid
