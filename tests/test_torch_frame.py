"""The slice as a whole: the port's frame (plain versions, on the CPU)
against the JAX package's frame (its CPU path) on the same carried-across
scene and view. (What the slice refuses is in test_torch_unported.py.)"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.passes import (
    build_view_state as j_view, render_frame as j_render)
from zeldaengine_tpu.scene.demo import build_demo_scene as j_build
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.passes import build_view_state, render_frame
from zeldaengine_tpu_torch.passes.frame import render_rows
from zeldaengine_tpu_torch.scene import build_demo_scene
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta

from _torch_compare import assert_golden, to_numpy_leaves

torch.set_num_threads(1)

GRASS, ROCKS = 50, 4
VIEW = dict(time=0.1, roll_light=0.02)


def _both(**cfg_kw):
    """(JAX image, JAX aux, port scene, view, meta, config) for one
    configuration, the JAX scene and view carried across as NumPy."""
    kw = dict(point_light_kernel="unroll", **cfg_kw)
    jcfg, cfg = JCFG.replace(**kw), TEST_CONFIG.replace(**kw)
    jscene, jmeta, jworld = j_build(jcfg, grass=GRASS, rocks=ROCKS)
    jview = j_view(jworld, jcfg, **VIEW)
    jimg, jaux = j_render(jscene, jview, jmeta, jcfg)
    scene = scene_from_numpy(to_numpy_leaves(jscene), "cpu")
    view = view_from_numpy(to_numpy_leaves(jview), "cpu")
    meta = SceneMeta(**dataclasses.asdict(jmeta))
    return np.asarray(jimg), jaux, scene, view, meta, cfg


@pytest.fixture(scope="module")
def default_cfg():
    return _both()


@pytest.fixture(scope="module")
def reference_op_by_op(default_cfg):
    """The JAX package's frame of the default configuration with
    ``jax.disable_jit()``: the same program, run one primitive at a time,
    so that XLA cannot fuse a multiply into the add that follows it (the
    goldens and the comparisons above use it jitted)."""
    jcfg = JCFG.replace(point_light_kernel="unroll")
    jscene, jmeta, jworld = j_build(jcfg, grass=GRASS, rocks=ROCKS)
    jview = j_view(jworld, jcfg, **VIEW)
    with jax.disable_jit():
        img, aux = j_render(jscene, jview, jmeta, jcfg)
    return np.asarray(img), {k: np.asarray(aux[k]) for k in
                             ("shadowmap", "depth", "gbuffer_depth",
                              "tri_id")}


def _off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > 4 / 255).mean())


def test_frame_meets_golden_criterion_against_the_reference_op_by_op(
        default_cfg):
    """Default configuration (``shadow_bias=0``), same carried-across scene
    and view, against the JAX package's frame as it runs by default, jitted
    (the arithmetic its goldens were rendered with): the port fuses the
    multiply-adds that XLA fuses on the CPU in the setup, the vertex
    transforms and the raster depth, so the shadow map is the reference's
    bit for bit and the frame meets the golden criterion."""
    jimg, jaux, scene, view, meta, cfg = default_cfg
    img, aux = render_frame(scene, view, meta, cfg)
    assert tuple(img.shape) == (128, 128, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
    assert_golden(img.numpy(), jimg)
    # The shadow map bit for bit but at 2 texels: there a sliver triangle
    # whose edge values are all within rounding of zero passes the
    # reference's brute-force coverage test far outside its bbox, which
    # the pair raster never visits; such a texel can only be nearer in the
    # reference.
    sm, jsm = aux["shadowmap"].numpy(), np.asarray(jaux["shadowmap"])
    off = sm != jsm
    assert off.sum() <= 2 and (jsm[off] < sm[off]).all()
    same = aux["tri_id"].numpy() == np.asarray(jaux["tri_id"])
    assert same.mean() > 0.999
    for key in ("gbuffer_depth", "depth"):
        np.testing.assert_allclose(aux[key].numpy()[same],
                                   np.asarray(jaux[key])[same],
                                   atol=5e-5, rtol=0, err_msg=key)


def test_frame_meets_golden_criterion_with_a_compare_bias():
    """Against the JAX package's frame as it runs by default (jitted), both
    frames agree under the golden criterion once a compare-time shadow
    bias is set. (Without one they do not: see the next test.)"""
    jimg, jaux, scene, view, meta, cfg = _both(shadow_bias=4e-3)
    img, aux = render_frame(scene, view, meta, cfg)
    assert_golden(img.numpy(), jimg)
    covered = np.asarray(jaux["tri_id"]) >= 0
    assert 0.3 < covered.mean() < 0.99
    np.testing.assert_array_equal(aux["tri_id"].numpy() >= 0, covered)


def test_frame_default_config_differs_only_through_shadow_noise(
        default_cfg, reference_op_by_op):
    """At the default ``shadow_bias=0`` the shadow compare ``tap < z`` has
    no margin on surfaces facing the light, so one rounding upstream flips
    taps: the JAX package's frame run op by op (no fused multiply-adds) is
    1-6 % of values off its own jitted frame, where the golden criterion
    allows 1 %. The port follows the jitted arithmetic and lands well
    inside it; given the jitted reference's shadow map, its frame is the
    same frame."""
    jimg, jaux, scene, view, meta, cfg = default_cfg
    nimg, _ = reference_op_by_op
    same_map, _ = render_rows(
        scene, view, meta, cfg,
        shadowmap_override=torch.from_numpy(np.array(jaux["shadowmap"])))
    assert_golden(same_map.numpy(), jimg, "frame on the JAX shadow map")
    img, _ = render_frame(scene, view, meta, cfg)
    assert torch.equal(img, same_map)
    port_off, self_off = _off(img.numpy(), jimg), _off(nimg, jimg)
    assert 0.01 < self_off < 0.06   # op by op fails against jitted
    assert port_off < 0.002


def test_frame_aux_buffers(default_cfg):
    """Against the jitted reference's buffers: depths within 5e-5 (both
    interpolate depth in the same fused form; the first test holds the
    shadow map bit for bit), sky depth within 1e-4."""
    jimg, jaux, scene, view, meta, cfg = default_cfg
    _, aux = render_frame(scene, view, meta, cfg)
    same = aux["tri_id"].numpy() == np.asarray(jaux["tri_id"])
    assert same.mean() > 0.99  # ids equal off depth ties / edge pixels
    covered = (np.asarray(jaux["tri_id"]) >= 0) & same
    for key in ("gbuffer_depth", "depth"):
        dd = np.abs(aux[key].numpy() - np.asarray(jaux[key]))[covered]
        assert (dd <= 5e-5).mean() >= 0.99, key
        assert dd.max() <= 5e-3, key
    # Sky depth on uncovered pixels: 1e-4 (a matrix inverse and a
    # normalisation upstream).
    sky = (np.asarray(jaux["tri_id"]) < 0) & same
    np.testing.assert_allclose(aux["depth"].numpy()[sky],
                               np.asarray(jaux["depth"])[sky], atol=1e-4)
    sd = np.abs(aux["shadowmap"].numpy() - np.asarray(jaux["shadowmap"]))
    assert (sd <= 5e-5).mean() >= 0.98
    assert np.median(sd) == 0.0
    assert (sd > 5e-3).mean() < 0.002  # silhouette texels only
    assert int(aux["pair_overflow"]) == 0
    assert (aux["forward_tri_id"].numpy() == -1).all()


def test_port_builds_and_renders_its_own_scene(default_cfg):
    """End to end inside the port: own scene build, own view state."""
    jimg, jaux, scene, view, meta, cfg = default_cfg
    scene2, meta2, world2 = build_demo_scene(cfg, grass=GRASS, rocks=ROCKS,
                                             device="cpu")
    view2 = build_view_state(world2, cfg, device="cpu", **VIEW)
    assert meta2 == meta
    # (with the compare bias: the two views' shadow matrices differ by an
    # ulp, which is shadow noise at shadow_bias=0, see above)
    biased = cfg.replace(shadow_bias=4e-3)
    img_carried, _ = render_frame(scene, view, meta, biased)
    img_own, aux = render_frame(scene2, view2, meta2, biased)
    # Same package, inputs equal to 1e-6: the golden criterion.
    assert_golden(img_own.numpy(), img_carried.numpy())
    sf = aux["shadow_factor"][aux["tri_id"] >= 0]
    assert float(sf.min()) < float(sf.max())


def test_exact_pcf_backend_and_torch_raster_give_the_same_frame(default_cfg):
    _, _, scene, view, meta, cfg = default_cfg
    base, _ = render_frame(scene, view, meta, cfg)
    for kw in (dict(pcf_backend="exact"), dict(raster="torch"),
               dict(pcf_backend="vmem", subpixel_cull=True)):
        img, _ = render_frame(scene, view, meta, cfg.replace(**kw))
        covered_equal = torch.equal(img, base)
        if "pcf_backend" in kw and kw["pcf_backend"] == "exact":
            # "exact" does not gate uncovered pixels; sky overwrites them.
            assert_golden(img.numpy(), base.numpy())
        else:
            assert covered_equal, kw
