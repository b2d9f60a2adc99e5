"""The opt-in PCF backends of the port against the JAX package's on the
same NumPy inputs: the plain versions of kernels pcf_window_table (K7) and
pcf_window2d_table (K8) against the JAX kernels in interpret mode, and
compute_pcf_packed / _packed_roll / _window_roll / _half against the JAX
functions (run op by op). The CUDA kernels are held against their plain
versions on the card by chip_smoke.py."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.ops import shadow as js
from zeldaengine_tpu.ops.pcf_pallas import (
    build_pcf_window2d_table as j_table2d,
    build_pcf_window_table as j_table,
)
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.ops import pcf_tables
from zeldaengine_tpu_torch.ops import shadow as ts
from zeldaengine_tpu_torch.passes import build_view_state, render_frame
from zeldaengine_tpu_torch.scene import build_demo_scene

torch.set_num_threads(1)

D = 128


def _coords(kind, h=16, w=128, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        u = 0.15 + 0.0021 * xx + 0.0004 * yy
        v = 0.21 + 0.0019 * yy - 0.0003 * xx
        z = 0.4 + 0.2 * rng.random((h, w))
    else:  # wrap regions, out-of-range depth, huge footprints
        u = rng.random((h, w)) * 4.0 - 1.5
        v = rng.random((h, w)) * 4.0 - 1.5
        z = rng.random((h, w)) * 1.4 - 0.2
    sc = np.stack([u, v, z, np.ones((h, w))], -1).astype(np.float32)
    sc = sc * np.float32(1.3)  # homogeneous, w != 1
    sc[0, :, 3] = -1.0
    return sc


@pytest.mark.parametrize("radius,scale", [(2, 1.5), (1, 1.0), (3, 2.0)])
def test_window_tables_equal_jax_kernels(radius, scale):
    sm = np.random.default_rng(radius).random((D, D)).astype(np.float32)
    lo = int(math.floor(-scale * radius))
    hi = int(math.ceil(scale * radius))
    w_win = hi - lo + 1
    # Both tables are 8 x taps wide: a wider span keeps its first 8.
    lo_x, hi_x = lo, min(hi, lo + 7)
    want7 = j_table(jnp.asarray(sm), lo=lo_x, hi=hi_x, interpret=True)
    got7 = pcf_tables.build_pcf_window_table(torch.from_numpy(sm), lo=lo_x,
                                             hi=hi_x)
    np.testing.assert_array_equal(got7.numpy(), np.asarray(want7))
    want8 = j_table2d(jnp.asarray(sm), lo_x=lo_x, lo_y=lo, w_y=w_win,
                      interpret=True)
    got8 = pcf_tables.build_pcf_window2d_table(
        torch.from_numpy(sm), lo_x=lo_x, lo_y=lo, w_y=w_win)
    assert tuple(got8.shape) == (D * D, 8 * w_win)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    assert pcf_tables.build_pcf_window_table.launches == 0
    assert pcf_tables.build_pcf_window2d_table.launches == 0
    # The table backends over these tables (or, wider than 8 texels,
    # their packed fallback) equal the JAX package's.
    sc = _coords("wild", h=8, seed=radius)
    for name in ("compute_pcf_packed_roll", "compute_pcf_window_roll"):
        want = getattr(js, name)(jnp.asarray(sm), jnp.asarray(sc),
                                 radius=radius, scale=scale, bias=0.01,
                                 interpret=True)
        got = getattr(ts, name)(torch.from_numpy(sm), torch.from_numpy(sc),
                                radius=radius, scale=scale, bias=0.01)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)


@pytest.mark.parametrize("kind", ["smooth", "wild"])
def test_backends_equal_jax(kind):
    sm = np.random.default_rng(9).random((D, D)).astype(np.float32)
    sc = _coords(kind)
    cases = {
        "packed": (js.compute_pcf_packed, ts.compute_pcf_packed, {}),
        "packed_b": (js.compute_pcf_packed, ts.compute_pcf_packed,
                     dict(batch_rows=True)),
        "packed_roll": (js.compute_pcf_packed_roll,
                        ts.compute_pcf_packed_roll, {}),
        "window_roll": (js.compute_pcf_window_roll,
                        ts.compute_pcf_window_roll, {}),
        "half": (js.compute_pcf_half, ts.compute_pcf_half, {}),
        "half_nearest": (js.compute_pcf_half, ts.compute_pcf_half,
                         dict(upsample="nearest")),
        "half_wr": (js.compute_pcf_half, ts.compute_pcf_half,
                    dict(inner="window_roll")),
    }
    exact = ts.compute_pcf(torch.from_numpy(sm), torch.from_numpy(sc),
                           bias=0.002)
    for name, (jf, tf, kw) in cases.items():
        jkw = dict(kw, interpret=True) if name.endswith("roll") else kw
        want = jf(jnp.asarray(sm), jnp.asarray(sc), bias=0.002, **jkw)
        got = tf(torch.from_numpy(sm), torch.from_numpy(sc), bias=0.002,
                 **kw)
        assert got.shape == exact.shape, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        if not name.startswith("half"):  # exact tap for tap
            np.testing.assert_array_equal(got.numpy(), exact.numpy(), name)


def test_table_wrappers_refuse_cpu_tensors_for_the_cuda_backend():
    sm = torch.zeros((64, 64))
    with pytest.raises(RuntimeError, match="card"):
        pcf_tables.build_pcf_window_table(sm, backend="cuda")
    with pytest.raises(RuntimeError, match="card"):
        pcf_tables.build_pcf_window2d_table(sm, backend="cuda")
    with pytest.raises(AssertionError, match="8 channels"):
        pcf_tables.build_pcf_window_table(sm, lo=-6, hi=6)
    # Odd shapes take the full-resolution packed filter (the JAX rule).
    sc = torch.from_numpy(_coords("wild", h=5, w=7))
    np.testing.assert_array_equal(
        ts.compute_pcf_half(sm, sc).numpy(),
        ts.compute_pcf_packed(sm, sc).numpy())


def test_frame_through_each_pcf_backend():
    cfg = TEST_CONFIG.replace(shadow_bias=4e-3)
    scene, meta, world = build_demo_scene(cfg, grass=30, rocks=3,
                                          device="cpu")
    view = build_view_state(world, cfg, device="cpu", time=0.2)
    base, aux = render_frame(scene, view, meta, cfg)
    covered = aux["tri_id"] >= 0
    for backend in ("packed", "packed_b", "packed_roll", "window_roll",
                    "half", "half_nearest", "half_wr", "pallas"):
        img, a = render_frame(scene, view, meta,
                              cfg.replace(pcf_backend=backend))
        sf = a["shadow_factor"][covered]
        ref = aux["shadow_factor"][covered]
        if backend in ("packed", "packed_b", "packed_roll", "window_roll"):
            assert torch.equal(sf, ref), backend
            assert torch.equal(img, base), backend
        else:  # approximate: the factor moves, the frame stays close
            assert float((sf != ref).float().mean()) < 0.5, backend
            assert float((img - base).abs().median()) == 0.0, backend
