"""Windowed PCF (pcf_backend="pallas"): kernel pcf_window's fixed order of
the tile sums gives the window origins of the JAX package's wrapper
arithmetic (``compute_pcf_pallas``), on the cases of
test_torch_pcf_window.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu_torch.ops import pcf_window

from _torch_pcf_window_cases import H, TILE_H, TILE_W, _case

torch.set_num_threads(1)


def _jax_wrapper_origins(sm, sc, win, valid, radius=2, scale=1.5):
    """The origins (wy, wx) of the JAX wrapper's arithmetic
    (zeldaengine_tpu/ops/pcf_pallas.py, compute_pcf_pallas), in jnp."""
    h, w = sc.shape[:2]
    dim = sm.shape[-1]
    win = min(win, dim)
    sc = jnp.asarray(sc)
    wq = sc[..., 3]
    safe_w = jnp.where(jnp.abs(wq) > 1e-20, wq, 1.0)
    z = sc[..., 2] / safe_w
    inrange = ((z > -1.0) & (z < 1.0) & (wq / safe_w > 0.0)).astype(
        jnp.float32)
    fx = jnp.mod(sc[..., 0] / safe_w * dim, float(dim))
    fy = jnp.mod(sc[..., 1] / safe_w * dim, float(dim))
    weight = inrange
    if valid is not None:
        weight = weight * jnp.asarray(valid).astype(jnp.float32)

    def tile_mean(a):
        t = lambda b: b.reshape(h // TILE_H, TILE_H, w // TILE_W,  # noqa
                                TILE_W)
        num = t(a * weight).sum(axis=(1, 3))
        den = t(weight).sum(axis=(1, 3))
        return jnp.where(den > 0.5, num / jnp.maximum(den, 1.0),
                         t(a).mean(axis=(1, 3)))

    geo = pcf_window.window_geometry(dim, radius, scale, win)
    wy = jnp.clip(jnp.round(tile_mean(fy) - win / 2).astype(jnp.int32)
                  + geo.pad_y, 0, geo.py_dim - win) // 8 * 8
    wx = jnp.clip(jnp.round(tile_mean(fx) - win / 2).astype(jnp.int32)
                  + geo.pad_x, 0, geo.px_dim - win) // 128 * 128
    return np.stack([np.asarray(wy), np.asarray(wx)], -1)


@pytest.mark.parametrize("kind", ["in_window", "out_of_window",
                                  "all_invalid_tile", "ragged_height"])
def test_fixed_order_origins_equal_the_jax_wrapper(kind):
    """The kernel's fixed order of the tile sums (sequential per thread,
    then halving trees over lanes and warps) gives the origins of the JAX
    wrapper's arithmetic: with a tile whose pixels all weigh 0 (the plain
    mean) and with a ragged height, which the JAX side pads with zeros as
    the frame padded it and the port reads as zeros past the frame (its
    all-invalid tile's plain mean counts the zero rows)."""
    sm, sc, win, valid = _case("in_window" if kind == "in_window"
                               else "out_of_window")
    if kind == "all_invalid_tile":
        valid = valid.copy()
        valid[:, :TILE_W] = False  # both tiles fall back to the plain mean
    rows = H - 5 if kind == "ragged_height" else H
    padded = np.zeros_like(sc)
    padded[:rows] = sc[:rows]
    want = _jax_wrapper_origins(sm, padded, win, valid)
    _, got = pcf_window.compute_pcf_pallas(
        torch.from_numpy(sm), torch.from_numpy(sc[:rows]), tile_h=TILE_H,
        tile_w=TILE_W, win=win, return_origins=True,
        valid=None if valid is None else torch.from_numpy(valid[:rows]))
    np.testing.assert_array_equal(got.numpy(), want)
    # The sums in PyTorch are the kernel's order, not a plain .sum().
    a = torch.from_numpy(sc[..., 0].copy())
    plain = a.reshape(1, TILE_H, 2, TILE_W).sum(dim=(1, 3))
    ordered = pcf_window.tile_sums_plain(a, TILE_H, TILE_W)
    np.testing.assert_allclose(ordered.numpy(), plain.numpy(), rtol=1e-6)
