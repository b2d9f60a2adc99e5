"""Windowed PCF (pcf_backend="pallas"): the plain version of kernel
pcf_window against the JAX package's compute_pcf_pallas, whose Pallas
kernel runs here under force_tpu_interpret_mode(). The CUDA kernel is held
against its plain version on the card by chip_smoke.py.

The TPU kernel reads depths through a bf16 hi/lo split (good to ~2^-16
relative); the port reads the exact fp32 depth. So the two may classify a
tap differently only where |tap - (z - bias)| <= 2^-15 |tap|: every
difference of the factor must be covered by such near ties, counted at
the taps the port's window addressing reads."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zeldaengine_tpu.ops.pcf_pallas import compute_pcf_pallas as j_pcf_pallas
from zeldaengine_tpu_torch.ops import pcf_window
from zeldaengine_tpu_torch.ops.shadow import compute_pcf

torch.set_num_threads(1)

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


def _near_ties(sm, sc, win, valid, radius=2, scale=1.5):
    """Per pixel: the taps the port reads whose depth lies within
    2^-15 |tap| of z - bias (bias 0 here)."""
    inp, win = pcf_window.pcf_window_inputs(
        torch.from_numpy(sm), torch.from_numpy(sc), radius, scale, 0.0,
        TILE_H, TILE_W, win,
        None if valid is None else torch.from_numpy(valid))
    org = inp.origins.repeat_interleave(TILE_H, 0).repeat_interleave(
        TILE_W, 1)
    flat = inp.sm_padded.reshape(-1)
    ties = torch.zeros((H, W), dtype=torch.int32)
    for j in range(-radius, radius + 1):
        ry = torch.clamp(torch.floor(inp.fy + scale * j).int() - org[..., 0],
                         0, win - 1)
        for i in range(-radius, radius + 1):
            cx = torch.clamp(
                torch.floor(inp.fx + scale * i).int() - org[..., 1],
                0, win - 1)
            tap = flat[((org[..., 0] + ry) * inp.sm_padded.shape[1]
                        + org[..., 1] + cx).long()]
            near = (tap - inp.zcmp).abs() <= 2.0 ** -15 * tap.abs()
            ties += (near & (inp.inrange > 0.5)).int()
    return ties.numpy()


def _occluded_taps(f):
    return np.round((25.0 - np.asarray(f, np.float64) * 25.0) / 0.9)


@pytest.mark.parametrize("kind", ["in_window", "out_of_window"])
def test_plain_matches_jax_kernel(kind):
    sm, sc, win, valid = _case(kind)
    with pltpu.force_tpu_interpret_mode():
        want = j_pcf_pallas(
            jnp.asarray(sm), jnp.asarray(sc), tile_h=TILE_H, tile_w=TILE_W,
            win=win, valid=None if valid is None else jnp.asarray(valid))
    got = pcf_window.compute_pcf_pallas(
        torch.from_numpy(sm), torch.from_numpy(sc), tile_h=TILE_H,
        tile_w=TILE_W, win=win,
        valid=None if valid is None else torch.from_numpy(valid))
    assert pcf_window.pcf_window_taps.launches == 0
    want, got = np.asarray(want), got.numpy()
    ties = _near_ties(sm, sc, win, valid)
    dk = np.abs(_occluded_taps(got) - _occluded_taps(want))
    assert (dk <= ties).all(), (dk[dk > ties], ties[dk > ties])
    same = dk == 0
    # 6e-8: one ulp of the final division (tests/test_pcf_vmem.py).
    np.testing.assert_allclose(got[same], want[same], atol=6e-8, rtol=0)
    exact = compute_pcf(torch.from_numpy(sm), torch.from_numpy(sc)).numpy()
    off_exact = float((np.abs(got - exact) > 1e-6).mean())
    if kind == "in_window":
        assert off_exact == 0.0
    else:
        # The window clamp is visible: the approximation of this backend.
        assert off_exact > 0.1


def test_origins_padding_and_wrapper_checks():
    sm, sc, win, valid = _case("in_window")
    inp, win = pcf_window.pcf_window_inputs(
        torch.from_numpy(sm), torch.from_numpy(sc), 2, 1.5, 0.0, TILE_H,
        TILE_W, 512)
    assert win == DIM  # clipped to the map
    # Aligned origins; the padded map wraps (padded index i is (i - pad)
    # mod DIM, pad 8 rows and 128 columns at radius 2).
    assert (inp.origins[..., 0] % 8 == 0).all()
    assert (inp.origins[..., 1] % 128 == 0).all()
    np.testing.assert_array_equal(inp.sm_padded[8:8 + DIM, 128:128 + DIM],
                                  sm)
    np.testing.assert_array_equal(inp.sm_padded[:8, :128], sm[-8:, -128:])
    assert inp.sm_padded.shape == (272, 512)
    with pytest.raises(RuntimeError, match="card"):
        pcf_window.pcf_window_taps(inp, 2, 1.5, TILE_H, TILE_W, win,
                                   backend="cuda")
