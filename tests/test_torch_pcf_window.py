"""Windowed PCF (pcf_backend="pallas"): the plain version of kernel
pcf_window against the JAX package's compute_pcf_pallas, whose Pallas
kernel runs here under force_tpu_interpret_mode(). The CUDA kernel is held
against its plain version on the card by chip_smoke.py. Its window
origins against the JAX wrapper's arithmetic are in
test_torch_pcf_window_origins.py.

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

from _torch_pcf_window_cases import DIM, H, W, TILE_H, TILE_W, _case

torch.set_num_threads(1)


def _near_ties(sm, sc, win, valid, radius=2, scale=1.5):
    """Per pixel: the taps the port reads whose depth lies within
    2^-15 |tap| of z - bias (bias 0 here)."""
    inp = pcf_window.pcf_window_inputs(
        torch.from_numpy(sc), DIM, radius, scale, 0.0, TILE_H, TILE_W, win,
        None if valid is None else torch.from_numpy(valid))
    flat = torch.from_numpy(sm).reshape(-1)
    ties = torch.zeros(inp.fx.shape, dtype=torch.int32)
    offs = pcf_window.tap_offsets(radius, scale)
    for oy in offs:
        for ox in offs:
            tap = flat[pcf_window.pcf_window_tap_index(inp, oy, ox, TILE_H,
                                                       TILE_W)]
            near = (tap - inp.zcmp).abs() <= 2.0 ** -15 * tap.abs()
            ties += (near & inp.inrange).int()
    return ties[:H, :W].numpy()


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
    assert pcf_window.compute_pcf_pallas.launches == 0
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


@pytest.mark.parametrize("dim", [256, 64])
def test_origins_padding_and_wrapper_checks(dim):
    """The taps read the unpadded map where mode="wrap" padding held the
    same texel (also for a 64-texel map, narrower than the 128-column pad);
    origins are aligned; the wrapper refuses CPU tensors for the kernel."""
    rng = np.random.default_rng(dim)
    sm = rng.random((dim, dim)).astype(np.float32)
    geo = pcf_window.window_geometry(dim, 2, 1.5, 512)
    assert geo.win == dim  # clipped to the map
    assert (geo.pad_y, geo.pad_x) == (8, 128)
    assert (geo.py_dim, geo.px_dim) == {256: (272, 512), 64: (80, 256)}[dim]
    padded = np.pad(sm, ((geo.pad_y, geo.py_dim - dim - geo.pad_y),
                         (geo.pad_x, geo.px_dim - dim - geo.pad_x)),
                    mode="wrap")
    for win in (geo.win, 8):
        wy = torch.arange(0, geo.py_dim - win + 1)
        wx = torch.arange(0, geo.px_dim - win + 1)
        rows = pcf_window.wrap_window(wy[:, None], geo.pad_y,
                                      torch.arange(win), dim)
        cols = pcf_window.wrap_window(wx[:, None], geo.pad_x,
                                      torch.arange(win), dim)
        for y in range(0, wy.shape[0], 8):
            for x in range(0, wx.shape[0], 128 if win == dim else 37):
                np.testing.assert_array_equal(
                    sm[rows[y].numpy()][:, cols[x].numpy()],
                    padded[y:y + win, x:x + win])
    # A tap's index: the window clamp, then the same wrap.
    sc = np.concatenate([rng.uniform(-1.5, 2.5, (H, W, 2)),
                         rng.uniform(-0.2, 1.2, (H, W, 1)),
                         np.ones((H, W, 1))], -1).astype(np.float32)
    inp = pcf_window.pcf_window_inputs(torch.from_numpy(sc), dim, 2, 1.5,
                                       0.0, TILE_H, TILE_W, 64)
    assert (inp.origins[..., 0] % 8 == 0).all()
    assert (inp.origins[..., 1] % 128 == 0).all()
    org = inp.origins.repeat_interleave(TILE_H, 0).repeat_interleave(
        TILE_W, 1).numpy()
    for off in (-3.0, 0.0, 3.0):
        idx = pcf_window.pcf_window_tap_index(inp, off, -off, TILE_H,
                                              TILE_W).numpy()
        ry = np.clip(np.floor(inp.fy.numpy() + np.float32(off)).astype(
            np.int64) - org[..., 0], 0, inp.geo.win - 1)
        cx = np.clip(np.floor(inp.fx.numpy() + np.float32(-off)).astype(
            np.int64) - org[..., 1], 0, inp.geo.win - 1)
        padded_map = np.pad(sm, ((8, inp.geo.py_dim - dim - 8),
                                 (128, inp.geo.px_dim - dim - 128)),
                            mode="wrap")
        np.testing.assert_array_equal(
            sm.reshape(-1)[idx],
            padded_map[org[..., 0] + ry, org[..., 1] + cx])
    with pytest.raises(RuntimeError, match="card"):
        pcf_window.compute_pcf_pallas(torch.from_numpy(sm),
                                      torch.from_numpy(sc), backend="cuda")


def test_kernel_divides_every_25_tap_sum_exactly():
    """Kernel pcf_window divides a 25-tap sum as q = total * fl(1/25)
    corrected by one fma step, fma(fma(-q, 25, total), fl(1/25), q). Every
    sum of 25 taps of 0.1f and 1.0f (any order, f32 adds) gives the
    correctly rounded quotient, computed here in exact rationals."""
    from fractions import Fraction

    f32 = np.float32

    def rnd(x):  # nearest f32 to the rational x, ties to even
        f = f32(float(x))
        near = [np.nextafter(f, f32(-np.inf)), f, np.nextafter(f, f32(np.inf))]
        return min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                        int(np.array(c).view(np.int32)) & 1))

    sums = {f32(0.0)}
    for _ in range(25):
        sums = ({f32(s + f32(0.1)) for s in sums}
                | {f32(s + f32(1.0)) for s in sums})
    assert len(sums) == 124
    r = f32(1.0) / f32(25.0)
    for t in sums:
        q = f32(t * r)
        res = rnd(Fraction(float(t)) - 25 * Fraction(float(q)))
        got = rnd(Fraction(float(res)) * Fraction(float(r))
                  + Fraction(float(q)))
        want = f32(t / f32(25.0))
        assert rnd(Fraction(float(t)) / 25) == want
        assert got.view(np.int32) == want.view(np.int32), t
