"""The JAX package's ``raster`` values in the port: "jnp" (the brute-force
raster, then the gather path ``surface_attributes``), "pallas" (kernel
``pair_raster`` with ids, then the gather path) and "fused" (the fused
kernel's planes, the port's "auto" route), each against the JAX package's
frame at the same value on the same carried-across demo scene and view.
The JAX side runs its Pallas kernels in interpret mode (the frame module's
``rasterize_pairs`` / ``rasterize_pairs_fused`` patched, as
test_torch_ablations.py patches that module); the port's kernels run their
plain versions here (CPU tensors)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.math.transforms import apply_mat4_h, apply_mat4_point
from zeldaengine_tpu.ops import pbr as j_pbr
from zeldaengine_tpu.ops import rasterize as j_rasterize
from zeldaengine_tpu.passes import (
    build_view_state as j_view, render_frame as j_render)
from zeldaengine_tpu.passes import frame as j_frame
from zeldaengine_tpu.passes import gbuffer as j_gbuffer
from zeldaengine_tpu.scene.demo import build_demo_scene as j_build
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.ops.rasterize import TriangleSetup
from zeldaengine_tpu_torch.passes.frame import render_frame, render_rows
from zeldaengine_tpu_torch.passes.gbuffer import surface_attributes
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta

from _torch_compare import assert_golden, to_numpy_leaves

torch.set_num_threads(1)

GRASS, ROCKS = 10, 2
VIEW = dict(time=0.1, roll_light=0.02)
# Unculled point lights on both sides (the JAX package culls only on an
# accelerator).
KW = dict(point_light_kernel="unroll")
AUX = ("shadowmap", "gbuffer_depth", "depth", "tri_id", "forward_tri_id")
# What the rasterizers write (``depth`` also holds the analytic sky's depth,
# whose arithmetic is not the raster's).
RASTER = ("shadowmap", "gbuffer_depth", "tri_id", "forward_tri_id")
# An unaligned band: it starts and ends inside 8-row tiles.
BAND = (37, 21)


@pytest.fixture(scope="module")
def demo():
    """(JAX config, scene, view, meta, the port's scene, view, meta) of
    the small demo scene, built by the JAX package and carried across."""
    jcfg = JCFG.replace(**KW)
    jscene, jmeta, jworld = j_build(jcfg, grass=GRASS, rocks=ROCKS)
    jview = j_view(jworld, jcfg, **VIEW)
    scene = scene_from_numpy(to_numpy_leaves(jscene), "cpu")
    view = view_from_numpy(to_numpy_leaves(jview), "cpu")
    meta = SceneMeta(**dataclasses.asdict(jmeta))
    return jcfg, jscene, jview, jmeta, scene, view, meta


def _jax_frame(demo, raster, interpret=(), **kw):
    """The JAX package's jitted frame at ``raster``: (image, aux) as NumPy.
    ``interpret`` names the frame module's Pallas entry points run in
    interpret mode."""
    jcfg, jscene, jview, jmeta = demo[:4]
    with pytest.MonkeyPatch.context() as mp:
        for name in interpret:
            mp.setattr(j_frame, name, functools.partial(
                getattr(j_frame, name), interpret=True))
        img, aux = j_render(jscene, jview, jmeta,
                            jcfg.replace(raster=raster, **kw))
        return np.asarray(img), {k: np.asarray(aux[k]) for k in AUX}


def _frame(demo, raster, **kw):
    """The port's frame at ``raster``: (image, aux) as NumPy."""
    scene, view, meta = demo[4:]
    img, aux = render_frame(scene, view, meta,
                            TEST_CONFIG.replace(raster=raster, **KW, **kw))
    assert bool(torch.isfinite(img).all())
    return img.numpy(), {k: aux[k].numpy() for k in AUX}


@pytest.fixture(scope="module")
def port_frames(demo):
    return {r: _frame(demo, r) for r in ("auto", "jnp", "pallas")}


def test_surface_attributes_matches_jax(demo):
    """The gather path against the JAX package's jitted
    ``surface_attributes`` on the same setup, visibility buffer and world
    positions and normals. The reference's bar between its two attribute
    paths is 2e-4 (tests/test_fused.py); the port follows the jitted
    function's fused multiply-adds (edge values, quotient rule, the corner
    mix, the TBN of ``_gathered_tangent_normal``), so the interpolants,
    bary_min, the material channels and the normal are bit for bit."""
    jcfg, jscene, jview, jmeta = demo[:4]
    scene = demo[4]

    @jax.jit
    def visibility(scene, view):
        world = apply_mat4_point(view.model, scene.pair_pos)
        n1 = apply_mat4_point(view.model, j_pbr.normalize(scene.pair_nrm))
        n_world = jax.numpy.einsum(
            "pij,pj->pi", scene.rot_table[scene.pair_rot], n1,
            precision=jax.lax.Precision.HIGHEST)
        setup = j_rasterize.triangle_setup(
            apply_mat4_h(view.view_proj, world)[scene.tri_vtx], jcfg.width,
            jcfg.height, two_sided=scene.tri_two_sided,
            valid_mask=scene.tri_valid & scene.tri_deferred)
        _, tid = j_rasterize.rasterize_visibility(
            setup, jcfg.height, jcfg.width, chunk=jcfg.tri_chunk)
        return world, n_world, setup, tid

    world, n_world, setup, tid = visibility(jscene, jview)
    want = jax.jit(lambda *a: j_gbuffer.surface_attributes(
        *a, jcfg, var_ch=jmeta.tex_channels,
        flat_normal=jmeta.flat_normal))(jscene, setup, tid, world, n_world)

    def t(x):
        return torch.from_numpy(np.array(x))

    got = surface_attributes(
        scene, TriangleSetup(*map(t, setup)), t(tid), t(world), t(n_world),
        TEST_CONFIG.replace(**KW), var_ch=jmeta.tex_channels,
        flat_normal=jmeta.flat_normal)
    cov = np.asarray(want.covered)
    assert 0.3 < cov.mean() < 0.99
    np.testing.assert_array_equal(got.covered.numpy(), cov)
    err = {}
    for name in ("world_pos", "normal", "vertex_color", "base_color",
                 "metallic", "roughness", "ao", "emissive", "mask",
                 "bary_min"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        np.testing.assert_allclose(a[cov], b[cov], atol=2e-4, rtol=2e-4,
                                   err_msg=name)
        err[name] = float(np.abs(a[cov].astype(np.float64) - b[cov]).max())
    for name in ("world_pos", "vertex_color", "bary_min"):
        assert (getattr(got, name).numpy()[~cov] == 0.0).all(), name
        assert (np.asarray(getattr(want, name))[~cov] == 0.0).all(), name
    assert err.pop("normal") == 0.0
    assert max(err.values()) == 0.0, err


def test_jnp_frame_matches_jax_jnp(demo, port_frames):
    """Both sides brute force: the shadow map, the GBuffer depth and its
    ids bit for bit (the sliver texels the pair raster never visits agree
    here, ROADMAP.md §C), the image by the golden criterion."""
    jimg, jaux = _jax_frame(demo, "jnp")
    img, aux = port_frames["jnp"]
    for key in RASTER:
        np.testing.assert_array_equal(aux[key], jaux[key], err_msg=key)
    assert_golden(img, jimg, "jnp")


def test_pallas_frame_matches_jax_pallas(demo, port_frames):
    """The JAX frame at "pallas" (its pair kernel in interpret mode, the
    shadow map on) against the port's: depths bit for bit, ids equal (no
    exact depth tie on this view), the image by the golden criterion. The
    port's "pallas" frame has the same depth and ids as its "auto" frame
    (kernels pair_raster and pair_raster_fused share the walk and the
    winner rule)."""
    jimg, jaux = _jax_frame(demo, "pallas", interpret=("rasterize_pairs",))
    img, aux = port_frames["pallas"]
    for key in RASTER:
        np.testing.assert_array_equal(aux[key], jaux[key], err_msg=key)
    for key in AUX:
        np.testing.assert_array_equal(aux[key], port_frames["auto"][1][key],
                                      err_msg=key)
    assert_golden(img, jimg, "pallas")


def test_fused_frame_is_the_auto_frame(demo, port_frames):
    """"fused" takes the port's "auto" route (kernel pair_raster_fused's
    planes) bit for bit, and meets the golden criterion against the JAX
    frame at "fused" (both its raster kernels in interpret mode)."""
    img, aux = _frame(demo, "fused")
    np.testing.assert_array_equal(img, port_frames["auto"][0])
    for key in AUX:
        np.testing.assert_array_equal(aux[key], port_frames["auto"][1][key],
                                      err_msg=key)
    jimg, _ = _jax_frame(demo, "fused", interpret=(
        "rasterize_pairs", "rasterize_pairs_fused"))
    assert_golden(img, jimg, "fused")


@pytest.mark.parametrize("raster", ["jnp", "pallas"])
def test_band_equals_the_full_frame_rows(demo, port_frames, raster):
    """An unaligned row band through the route (the "pallas" band renders
    the tile rows that hold it, cropped) equals the full frame's rows."""
    scene, view, meta = demo[4:]
    y0, rows = BAND
    img, aux = render_rows(scene, view, meta,
                           TEST_CONFIG.replace(raster=raster, **KW), y0=y0,
                           rows=rows, full_frame=False)
    full_img, full_aux = port_frames[raster]
    np.testing.assert_array_equal(img.numpy(), full_img[y0:y0 + rows])
    for key in ("gbuffer_depth", "tri_id", "depth"):
        np.testing.assert_array_equal(aux[key].numpy(),
                                      full_aux[key][y0:y0 + rows],
                                      err_msg=key)
    np.testing.assert_array_equal(aux["shadowmap"].numpy(),
                                  full_aux["shadowmap"])


def test_pallas_wireframe_matches_jax(demo):
    """Wireframe at "pallas" against the JAX frame at "jnp" with the
    wireframe on: the gather path's bary_min keeps the same edge pixels,
    and the image meets the golden criterion."""
    jimg, jaux = _jax_frame(demo, "jnp", wireframe=True)
    img, aux = _frame(demo, "pallas", wireframe=True)
    np.testing.assert_array_equal(aux["tri_id"], jaux["tri_id"])
    edge = aux["tri_id"] >= 0
    assert 0.02 < edge.mean() < 0.8
    assert_golden(img, jimg, "wireframe")
