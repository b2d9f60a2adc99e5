"""The numbers behind the second slice's CPU findings (culled point lights,
windowed PCF), port against the JAX package on the same NumPy inputs:

    JAX_PLATFORMS=cpu python tests/torch_lights_pcf_report.py

Prints one JSON line each:

- ``point_lights``: the largest difference between the plain version of
  kernel point_lights and the JAX point-light kernel (interpret mode) on
  test_torch_point_lights.py's scene, block heights 8 and 40;
- ``tiled_vs_unrolled``: the port's tiled loop and kernel path against its
  unrolled loop on the scene of tests/test_light_culling.py
  (``test_tiled_matches_bruteforce``, which fails in the JAX package);
- ``pcf_window``: the windowed PCF (pcf_backend "pallas") against the exact
  25-tap filter, and the port's plain version against the JAX kernel, for
  an in-window case, a whole-map window whose taps spread over ~77 texels,
  and a 128-texel window under ~200-texel footprints.

tests/test_torch_point_lights.py and tests/test_torch_pcf_window.py assert
the tolerances; this script is not collected by pytest.
"""

import json
import os
import sys
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from zeldaengine_tpu.ops.lighting_pallas import (  # noqa: E402
    point_lighting_pallas)
from zeldaengine_tpu.ops.pcf_pallas import (  # noqa: E402
    compute_pcf_pallas as j_pcf_pallas)
from zeldaengine_tpu_torch.ops import lighting_cuda, pcf_window  # noqa: E402
from zeldaengine_tpu_torch.ops.shadow import compute_pcf  # noqa: E402

import test_torch_pcf_window as pw  # noqa: E402
import test_torch_point_lights as pl  # noqa: E402


def point_lights():
    out = {}
    for block_h in (8, 40):
        s = pl._scene()
        h, w = s["rough"].shape
        want_c, got_c = pl._cull_both(s, block_h, 128, 8)
        acc = np.random.default_rng(3).uniform(0, 0.2, (h, w, 3)).astype(
            np.float32)
        keys = ("dc", "rough", "n", "p", "v", "ndotv")
        want = np.asarray(point_lighting_pallas(
            jnp.asarray(acc), *(jnp.asarray(s[k]) for k in keys),
            jnp.asarray(s["lights"]), *(jnp.asarray(a) for a in want_c[:2]),
            block_h=block_h, interpret=True))
        got = lighting_cuda.point_lighting(
            torch.from_numpy(acc), *(torch.from_numpy(s[k]) for k in keys),
            torch.from_numpy(s["lights"]),
            *(torch.from_numpy(a) for a in got_c[:2]),
            block_h=block_h).numpy()
        d = np.abs(got - want)
        out[f"block_h_{block_h}"] = dict(
            max_abs=float(d.max()), values_not_equal=int((d > 0).sum()),
            values=int(d.size))
    print(json.dumps({"point_lights": out}))


def tiled_vs_unrolled():
    """tests/test_light_culling.py::test_tiled_matches_bruteforce in both
    packages: 60 lights over a plane, no shadow, no sky, a 96-slot table
    (tiled loop, 8x128 tiles, cap 80; and in the port also the kernel
    path's plain version, 40x128 blocks) against a 64-slot table (the
    unrolled loop). The JAX test holds the two to atol 2e-6 and fails."""
    from zeldaengine_tpu.config import TEST_CONFIG as JCFG
    from zeldaengine_tpu.passes.frame import render_rows as j_rows
    from zeldaengine_tpu.passes.view import build_view_state as j_view
    from zeldaengine_tpu.scene import mesh as jmesh, scenebuild as jsb
    from zeldaengine_tpu.scene import world as jw
    from zeldaengine_tpu_torch import TEST_CONFIG
    from zeldaengine_tpu_torch.passes import build_view_state
    from zeldaengine_tpu_torch.passes.frame import render_rows
    from zeldaengine_tpu_torch.scene import make_plane
    from zeldaengine_tpu_torch.scene.scenebuild import SceneBuilder
    from zeldaengine_tpu_torch.scene.world import CameraDesc, LightDesc, World

    kw = dict(enable_shadow=False, enable_skydome=False, max_point_lights=96,
              max_tile_lights=80, point_light_kernel="unroll")

    def world(mod_w):
        rng = np.random.RandomState(0)
        w = mod_w.World()
        w.main_camera = mod_w.CameraDesc(
            position=np.array([0.0, -6.0, 6.0], np.float32),
            lookat=np.array([0.0, 0.0, 0.0], np.float32))
        for _ in range(60):
            w.point_lights.append(mod_w.LightDesc(
                position=np.array([rng.uniform(-5, 5), rng.uniform(-5, 5),
                                   0.7], np.float32),
                type=1, color=np.array([rng.uniform(0.3, 1),
                                        rng.uniform(0.3, 1),
                                        rng.uniform(0.3, 1)], np.float32),
                intensity=4.0, radius=1.2))
        return w

    def scene(sb, mk, cfg, *dev):
        b = sb.SceneBuilder(cfg)
        b.enable_skydome = False
        b.add_object(mk(12.0), b.add_material({}))
        return b.build(*dev)

    jcfg = JCFG.replace(**kw)
    jscene, jmeta = scene(jsb, jmesh.make_plane, jcfg)
    jworld = world(jw)

    def jrender(cap):
        view = j_view(jworld, jcfg, light_capacities=(2, cap, 2),
                      animate_point_lights=False)
        # The view's leaves are host NumPy arrays; the JAX tiled loop
        # indexes the light table with a traced index, which a NumPy
        # table refuses (TracerArrayConversionError: what makes the JAX
        # test fail). Device arrays carry the same values.
        view = view._replace(point_lights=jnp.asarray(view.point_lights))
        return np.asarray(j_rows(jscene, view, jmeta, jcfg)[0])

    cfg = TEST_CONFIG.replace(**kw)
    tscene, tmeta = scene(types.SimpleNamespace(SceneBuilder=SceneBuilder),
                          make_plane, cfg, "cpu")
    tworld = world(types.SimpleNamespace(World=World, CameraDesc=CameraDesc,
                                         LightDesc=LightDesc))

    def trender(cap, **ckw):
        view = build_view_state(tworld, cfg, light_capacities=(2, cap, 2),
                                animate_point_lights=False, device="cpu")
        img, aux = render_rows(tscene, view, tmeta, cfg.replace(**ckw))
        return img.numpy(), int(aux["light_drops"])

    def gap(a, b):
        d = np.abs(a - b)
        return dict(max_abs=float(d.max()),
                    values_off_by_more_than_2e_6=int((d > 2e-6).sum()),
                    values=int(d.size))

    brute, _ = trender(64)
    tiled, drops_t = trender(96)
    kern, drops_k = trender(96, point_light_kernel="auto")
    print(json.dumps({"tiled_vs_unrolled": dict(
        jax_tiled_vs_unrolled=gap(jrender(96), jrender(64)),
        port_tiled_vs_unrolled=dict(gap(tiled, brute), light_drops=drops_t),
        port_kernel_path_vs_unrolled=dict(gap(kern, brute),
                                          light_drops=drops_k))}))


def pcf_window_cases():
    cases = {}
    for kind in ("in_window", "out_of_window"):
        sm, sc, win, valid = pw._case(kind)
        cases[kind] = (sm, sc, win, valid)
    # A whole-map window (win = 256 = dim) whose tiles' taps spread over
    # ~77 texels in x: the 128-column alignment still clamps.
    rng = np.random.default_rng(3)
    sm = rng.random((256, 256)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(32), np.arange(256), indexing="ij")
    u = 0.02 + 0.3 * xx / 128.0
    v = 0.4 + 0.001 * yy
    z = rng.random((32, 256))
    sc = np.stack([u, v, z, np.ones_like(u)], -1).astype(np.float32)
    cases["whole_map_window_77_texel_spread"] = (sm, sc, 256, None)
    out = {}
    for kind, (sm, sc, win, valid) in cases.items():
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else torch.from_numpy(valid)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(j_pcf_pallas(
                jnp.asarray(sm), jnp.asarray(sc), tile_h=32, tile_w=128,
                win=win, valid=jv))
        got = pcf_window.compute_pcf_pallas(
            torch.from_numpy(sm), torch.from_numpy(sc), tile_h=32,
            tile_w=128, win=win, valid=tv).numpy()
        exact = compute_pcf(torch.from_numpy(sm),
                            torch.from_numpy(sc)).numpy()
        off = np.abs(got - exact)
        dk = np.abs(pw._occluded_taps(got) - pw._occluded_taps(want))
        out[kind] = dict(
            window=win, pixels=int(got.size),
            vs_exact_fraction_off=float((off > 1e-6).mean()),
            vs_exact_max_abs=float(off.max()),
            jax_kernel_vs_exact_fraction_off=float(
                (np.abs(want - exact) > 1e-6).mean()),
            vs_jax_kernel_pixels_not_equal=int((got != want).sum()),
            vs_jax_kernel_max_abs=float(np.abs(got - want).max()),
            vs_jax_kernel_tap_classification_differences=int(dk.sum()),
            near_tie_taps=int(pw._near_ties(sm, sc, win, valid).sum()))
    print(json.dumps({"pcf_window": out}))


if __name__ == "__main__":
    torch.set_num_threads(1)
    point_lights()
    tiled_vs_unrolled()
    pcf_window_cases()
