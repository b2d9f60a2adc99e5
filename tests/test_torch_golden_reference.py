"""tests/test_golden.py's scene in the port against the JAX package: the
port's SceneBuilder gives the JAX package's pools, its shadow pass setup
and map match the jitted JAX pass, each debug view matches the jitted JAX
frame, and view 9's contact sheet honours the editor's viewport bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops import rasterize as jr
from zeldaengine_tpu.passes import render_frame as j_render
from zeldaengine_tpu_torch.math.transforms import (
    apply_mat4_h, apply_mat4_point)
from zeldaengine_tpu_torch.ops.rasterize import triangle_setup
from zeldaengine_tpu_torch.passes import render_frame

from _torch_compare import assert_golden, to_numpy_leaves
from test_golden import VIEWS, _build as j_build

from _torch_golden_scene import _build, _view, port_frames

torch.set_num_threads(1)

port = pytest.fixture(scope="module")(port_frames)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's golden scene and its jitted frame in every view
    (debug_view is traced there: one compilation)."""
    cfg, scene, meta, view = j_build()
    out = {name: j_render(scene, view._replace(debug_view=jnp.int32(dv)),
                          meta, cfg) for name, dv in VIEWS.items()}
    return cfg, scene, meta, view, out


def test_port_builds_the_reference_scene(port, reference):
    """The port's SceneBuilder gives the JAX package's pools bit for bit
    (bf16 atlases compared as their float32 values) and the same meta; the
    views agree to 1e-6."""
    _, scene, meta, view, _ = port
    _, jscene, jmeta, jview, _ = reference
    assert meta.tex_channels == jmeta.tex_channels == (0, 1, 2)
    assert meta.has_forward and meta.has_deferred
    for k, v in to_numpy_leaves(jscene).items():
        got = getattr(scene, k)
        assert (v is None) == (got is None), k
        if v is not None:
            np.testing.assert_array_equal(got.float().numpy(), v,
                                          err_msg=k)
    for k, v in to_numpy_leaves(jview).items():
        np.testing.assert_allclose(getattr(view, k).numpy(), v, atol=1e-6,
                                   err_msg=k)


def test_shadow_pass_setup_and_map_match_the_jitted_jax(port, reference):
    """The golden scene's shadow pass: the vertex transforms and
    triangle_setup (depth bias included) bit for bit against the same
    steps jitted in the JAX package, and the port's shadow map equal to
    the jitted frame's at every texel."""
    cfg, scene, _, view, out = port
    jcfg, jscene, _, jview, jout = reference
    dim = cfg.shadowmap_dim
    bias = (cfg.shadow_bias_constant, cfg.shadow_bias_slope)

    @jax.jit
    def j_setup(s, v):
        from zeldaengine_tpu.math.transforms import (
            apply_mat4_h as h, apply_mat4_point as p)

        clip = h(v.shadow_space, p(v.model, s.pair_pos))
        return clip, jr.triangle_setup(clip[s.tri_vtx], dim, dim,
                                       two_sided=True,
                                       valid_mask=s.tri_valid,
                                       depth_bias=bias)

    jclip, js = j_setup(jscene, jview)
    clip = apply_mat4_h(torch.from_numpy(np.array(jview.shadow_space)),
                        apply_mat4_point(
                            torch.from_numpy(np.array(jview.model)),
                            scene.pair_pos))
    np.testing.assert_array_equal(clip.numpy(), np.asarray(jclip))
    ts = triangle_setup(clip[scene.tri_vtx.long()], dim, dim,
                        two_sided=True, valid_mask=scene.tri_valid,
                        depth_bias=bias)
    for k in ("edge", "zc", "valid", "bbox", "zmin"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_array_equal(out["final"][1]["shadowmap"].numpy(),
                                  np.asarray(jout["final"][1]["shadowmap"]))


def test_views_match_the_jitted_frame(port, reference):
    """Each view against the JAX package's jitted frame of the same scene
    (the goldens' source), by the golden criterion, and the GBuffer and
    forward triangle ids equal. (The forward sphere lies inside the cube:
    it is rasterized and z-tested, and loses every pixel.)"""
    out, jout = port[4], reference[4]
    for name in VIEWS:
        assert_golden(out[name][0].numpy(), np.asarray(jout[name][0]), name)
    aux, jaux = out["final"][1], jout["final"][1]
    for k in ("tri_id", "forward_tri_id"):
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)
    assert (aux["forward_tri_id"].numpy() == -1).all()
    assert int(aux["live_pairs"]["forward"]) > 0


def test_gbuffer_vis_honours_the_viewport_bars(reference):
    """View 9's contact sheet with the editor's right and bottom bars
    reserved (viewportInfo), against the JAX package's jitted frame."""
    cfg, scene, meta, view = _build(right_bar=24.0, bottom_bar=16.0)
    jcfg, jscene, jmeta, jview, _ = reference
    jview = jview._replace(viewport=jnp.asarray(view.viewport.numpy()),
                           debug_view=jnp.int32(9))
    img, _ = render_frame(scene, _view(view, 9), meta, cfg)
    jimg, _ = j_render(jscene, jview, jmeta, jcfg)
    assert_golden(img.numpy(), np.asarray(jimg), "view 9 with bars")
    plain, _ = render_frame(scene, _view(_build()[3], 9), meta, cfg)
    assert not torch.equal(img, plain)
