"""Shading ops of the port (lighting, GBuffer; the pbr terms are in
test_torch_pbr_*.py) against the JAX
package on the same seeded inputs. Tolerance 1e-5 unless stated: the same
fp32 formulas, evaluated by two compilers (XLA contracts multiply-adds,
transcendentals differ in the last ulp)."""

import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.ops import lighting as jl
from zeldaengine_tpu.passes import gbuffer as jg
from zeldaengine_tpu.passes.view import build_view_state as j_view
from zeldaengine_tpu.scene.demo import build_demo_scene as j_build
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.ops import lighting as tl
from zeldaengine_tpu_torch.passes import gbuffer as tg

from _torch_compare import to_numpy_leaves
from _torch_pbr_cases import HW, J, T, close as _close, unit as _unit

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def px():
    rng = np.random.default_rng(11)
    return dict(
        base_color=rng.random(HW + (3,)).astype(np.float32),
        metallic=rng.random(HW).astype(np.float32),
        roughness=(0.05 + 0.95 * rng.random(HW)).astype(np.float32),
        normal=_unit(rng, HW),
        ao=rng.random(HW).astype(np.float32),
        world_pos=(rng.normal(size=HW + (3,)) * 3).astype(np.float32),
        shadow=rng.choice([0.1, 0.64, 1.0], HW).astype(np.float32),
        v=_unit(rng, HW),
    )


@pytest.fixture(scope="module")
def views():
    scene, meta, world = j_build(JCFG, grass=5, rocks=1)
    jv = j_view(world, JCFG, time=0.3, roll_light=0.2)
    tv = view_from_numpy(to_numpy_leaves(jv), "cpu")
    ts = scene_from_numpy(to_numpy_leaves(scene), "cpu")
    return scene, ts, jv, tv, meta


def test_direct_lighting_unrolled_16_point_lights(px, views):
    _, _, jv, tv, _ = views
    assert jv.point_lights.shape[0] == 16 and int(jv.lights_count[1]) == 16
    args = ("base_color", "roughness", "normal", "world_pos", "v", "ao",
            "shadow")
    ndotv = np.clip((px["normal"] * px["v"]).sum(-1), 0, 1)
    want = jl.direct_lighting(
        *(J(px[k]) for k in args[:5]), J(ndotv), J(px["shadow"]),
        jv.dir_lights, jv.lights_count[0], jv.point_lights,
        jv.lights_count[1], jv.spot_lights, jv.lights_count[2])
    got = tl.direct_lighting(
        *(T(px[k]) for k in args[:5]), T(ndotv), T(px["shadow"]),
        tv.dir_lights, int(tv.lights_count[0]), tv.point_lights,
        int(tv.lights_count[1]), tv.spot_lights, int(tv.lights_count[2]))
    _close(got, want, atol=1e-5, rtol=5e-5)
    # The tiled loop over lists that hold all 16 lights in every tile gives
    # the same sum (the lists a cull would make are tested in
    # test_torch_point_lights.py).
    n_ty = -(-HW[0] // 8)
    idx = torch.arange(16, dtype=torch.int32).expand(n_ty, 1, 16)
    cnt = torch.full((n_ty, 1), 16, dtype=torch.int32)
    tiled = tl.direct_lighting(
        *(T(px[k]) for k in args[:5]), T(ndotv), T(px["shadow"]),
        tv.dir_lights, int(tv.lights_count[0]), tv.point_lights, 16,
        tiled_points=(idx, cnt, 8, HW[1]))
    _close(tiled, want, atol=1e-5, rtol=5e-5)


def test_spot_lights_match_jax(px):
    lights = np.zeros((2, 4, 4), np.float32)
    lights[0] = [[1, 1, 3, 2], [1, 0.5, 0.2, 4], [0, 0, -1, 9],
                 [0.95, 0.8, 0, 0]]
    ndotv = np.clip((px["normal"] * px["v"]).sum(-1), 0, 1)
    none = np.zeros((1, 4, 4), np.float32)
    common = ("base_color", "roughness", "normal", "world_pos", "v")
    want = jl.direct_lighting(
        *(J(px[k]) for k in common), J(ndotv), J(px["shadow"]),
        J(none), 0, J(none), 0, J(lights), 1)
    got = tl.direct_lighting(
        *(T(px[k]) for k in common), T(ndotv), T(px["shadow"]),
        T(none), 0, T(none), 0, T(lights), 1)
    _close(got, want, atol=1e-5, rtol=5e-5)


def test_reflection_color_cube_const(px, views):
    jscene, tscene, *_ = views
    assert jscene.cube_const is not None
    # A cube table with distinct texels, so that face and corner selection
    # are visible (the demo's faces are flat).
    table = np.random.default_rng(5).random((6, 2, 2, 3)).astype(np.float32)
    ndotv = np.clip((px["normal"] * px["v"]).sum(-1), 0, 1)
    args = ("base_color", "metallic", "roughness", "normal", "v")
    want = jl.reflection_color(
        *(J(px[k]) for k in args), J(ndotv), J(px["ao"]), jscene.cube_atlas,
        JCFG.cubemap_size, JCFG.cubemap_mips, cube_pair1=jscene.cube_pair1,
        cube_const=J(table))
    got = tl.reflection_color(
        *(T(px[k]) for k in args), T(ndotv), T(px["ao"]), tscene.cube_atlas,
        TEST_CONFIG.cubemap_size, float(TEST_CONFIG.cubemap_mips),
        cube_pair1=tscene.cube_pair1, cube_const=T(table))
    _close(got, want, atol=2e-5, rtol=5e-5)
    # Without the table: the variable-lod tiers (test_torch_texture.py).
    want = jl.reflection_color(
        *(J(px[k]) for k in args), J(ndotv), J(px["ao"]), jscene.cube_atlas,
        JCFG.cubemap_size, JCFG.cubemap_mips, cube_pair1=jscene.cube_pair1)
    got = tl.reflection_color(
        *(T(px[k]) for k in args), T(ndotv), T(px["ao"]), tscene.cube_atlas,
        TEST_CONFIG.cubemap_size, float(TEST_CONFIG.cubemap_mips),
        cube_pair1=tscene.cube_pair1)
    _close(got, want, atol=2e-5, rtol=5e-5)


@pytest.mark.parametrize("overrides", [None, (0.8, 0.5, 1.2, 0.7)])
def test_shade_pixels_matches_jax(px, views, overrides):
    jscene, tscene, jv, tv, _ = views
    if overrides is not None:
        jv = jv._replace(overrides=np.asarray(overrides, np.float32))
        tv = tv._replace(overrides=T(np.asarray(overrides, np.float32)))
    args = ("base_color", "metallic", "roughness", "normal", "ao",
            "world_pos", "shadow")
    want = jl.shade_pixels(
        *(J(px[k]) for k in args), jv, jscene.cube_atlas, JCFG.cubemap_size,
        cube_pair1=jscene.cube_pair1, cube_const=jscene.cube_const)
    got = tl.shade_pixels(
        *(T(px[k]) for k in args), tv, tscene.cube_atlas,
        TEST_CONFIG.cubemap_size, cube_pair1=tscene.cube_pair1,
        cube_const=tscene.cube_const)
    for key in ("direct", "indirect", "reflection", "final", "ndotv"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=5e-5,
            err_msg=key)


def _planes(seed=21):
    """Seeded fused-kernel planes with a plausible geometry: smooth uv and
    position fields so that the TBN is well conditioned."""
    rng = np.random.default_rng(seed)
    h, w = HW
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    p = np.zeros((24, h, w), np.float32)
    p[0] = (rng.random(HW) < 0.8) * (1.0 + 0.3 * rng.random(HW))
    p[2], p[3] = xx * 0.01, yy * 0.013
    p[4] = rng.random(HW) * 3
    p[5:8] = rng.random((3,) + HW)
    p[8:11] = np.stack([xx * 0.1, yy * 0.1, 0.05 * xx + 0.02 * yy])
    p[11:14] = np.moveaxis(_unit(rng, HW), -1, 0)
    p[14], p[15], p[16], p[17] = 0.01, 0.001, -0.002, 0.013
    p[18:21] = np.array([0.1, 0.0, 0.05], np.float32)[:, None, None]
    p[21:24] = np.array([0.0, 0.1, 0.02], np.float32)[:, None, None]
    return p.astype(np.float32)


def test_surface_attributes_and_gbuffer_match_jax(views):
    jscene, tscene, _, _, meta = views
    planes = _planes()
    ja = jg.surface_attributes_from_planes(
        jscene, J(planes), JCFG, var_ch=meta.tex_channels,
        flat_normal=meta.flat_normal)
    ta = tg.surface_attributes_from_planes(
        tscene, T(planes), TEST_CONFIG, var_ch=meta.tex_channels,
        flat_normal=meta.flat_normal)
    np.testing.assert_array_equal(ta.covered.numpy(), np.asarray(ja.covered))
    for name in ta._fields[1:]:
        np.testing.assert_allclose(
            getattr(ta, name).broadcast_to(
                np.asarray(getattr(ja, name)).shape).numpy(),
            np.asarray(getattr(ja, name)), atol=1e-5, err_msg=name)
    depth = np.where(planes[0] > 0.5, 0.5, 1.0).astype(np.float32)
    jb = jg.pack_gbuffer(ja, J(depth))
    tb = tg.pack_gbuffer(ta, T(depth))
    for name in tb._fields:
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        # Quantised targets: an ulp upstream may move a value one step
        # (1/1023 for the normal, 1/255 for the rest); almost none do.
        step = 1.0 / 1023 if name == "gbuffer_a" else 1.0 / 255
        diff = np.abs(got - want)
        assert diff.max() <= step + 1e-6, name
        assert (diff > 1e-5).mean() < 0.002, name


def test_select_chain_and_gather_material_tables(views):
    _, tscene, *_ = views
    rng = np.random.default_rng(2)
    for mc in (3, 12):
        table = torch.from_numpy(rng.random((mc, 16)).astype(np.float32))
        scene = tscene._replace(mat_const=table)
        combo = torch.from_numpy(rng.integers(0, mc, HW).astype(np.int32))
        tex = tg._material_texels(scene, TEST_CONFIG, combo, None, None, ())
        np.testing.assert_array_equal(
            tex.numpy(), table.numpy()[combo.numpy()][..., :13])
    # Varying channels are fetched from the atlas, which must hold them
    # (this scene's atlas holds one placeholder channel).
    with pytest.raises(AssertionError):
        tg._material_texels(tscene, TEST_CONFIG, combo, None, None, (0, 1))
