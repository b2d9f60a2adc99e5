"""The frame's diagnostic ablations (``config.ablate``, each flag a
substring test as in the JAX package) against the JAX package's jitted
frame on the same carried-across demo scene and view, in three frames that
together hold every flag: each frame meets the golden criterion against
the reference, is no further from it than the frame without the flags, and
differs from that frame where its flags act.

The JAX package's CPU frame resolves its attributes through the gather
path, whose ``surface_attributes`` has no "noattrs" branch (that flag acts
in ``surface_attributes_from_planes``, the fused path of an accelerator);
the frame holding "noattrs" is compared with the JAX frame whose gather
path is routed through that branch (plane 0 = covered * (1 + min
barycentric), as the fused kernel writes it)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG
from zeldaengine_tpu.passes import (
    build_view_state as j_view, render_frame as j_render)
from zeldaengine_tpu.passes import frame as j_frame
from zeldaengine_tpu.passes import gbuffer as j_gbuffer
from zeldaengine_tpu.scene import scenebuild as j_scenebuild
from zeldaengine_tpu.scene.demo import build_demo_scene as j_build
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.convert import scene_from_numpy, view_from_numpy
from zeldaengine_tpu_torch.passes import render_frame
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta

from _torch_compare import assert_golden, to_numpy_leaves

torch.set_num_threads(1)

GRASS, ROCKS = 50, 4
# The packed filter on both sides ("pcfbuild" acts in it; on the CPU the
# JAX package's "auto" takes it, the port's takes the tap kernel).
KW = dict(point_light_kernel="unroll", pcf_backend="packed")
# Every flag of the JAX package, in three frames. Flags that override
# another one's stage share no frame with it ("noattrs" skips the texture
# fetch of "lodprobe" / "notex"; "nolight" the shading of "nodirect",
# "norefl", "reflgather"; "nopcf" the filters of "pcfcoords" / "pcfbuild").
GROUPS = {
    "nopcf nolight nosky noattrs": (0,),
    "pcfcoords nodirect reflgather notex noswitch": (0, 1),
    "pcfbuild norefl lodprobe": (1, 7, 8),
}


def _noattrs_gather_path(scene, setup, tri_id, *a, **k):
    """The JAX package's gather path, sent through its "noattrs" branch of
    ``surface_attributes_from_planes`` when the flag is set."""
    attrs = j_gbuffer.surface_attributes(scene, setup, tri_id, *a, **k)
    config = a[2] if len(a) > 2 else k["config"]
    if "noattrs" not in config.ablate:
        return attrs
    plane0 = jnp.where(tri_id >= 0, 1.0 + attrs.bary_min, 0.0)
    planes = jnp.zeros((24,) + tri_id.shape, jnp.float32).at[0].set(plane0)
    return j_gbuffer.surface_attributes_from_planes(scene, planes, config)


@pytest.fixture(scope="module")
def demo():
    """The small demo scene with a seeded cubemap (its own is black: no
    reflection to ablate), built by the JAX package and carried across."""
    jcfg = JCFG.replace(**KW)
    faces = np.random.default_rng(23).random(
        (6, jcfg.cubemap_size, jcfg.cubemap_size, 4)).astype(np.float32)
    build = j_scenebuild.SceneBuilder.build

    def with_cubemap(self, *a, **k):
        self.set_cubemap(faces)
        return build(self, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_scenebuild.SceneBuilder, "build", with_cubemap)
        jscene, jmeta, jworld = j_build(jcfg, grass=GRASS, rocks=ROCKS)
    jview = j_view(jworld, jcfg, time=0.1, roll_light=0.02)
    scene = scene_from_numpy(to_numpy_leaves(jscene), "cpu")
    view = view_from_numpy(to_numpy_leaves(jview), "cpu")
    meta = SceneMeta(**dataclasses.asdict(jmeta))
    return jcfg, jscene, jview, jmeta, scene, view, meta


@pytest.fixture(scope="module")
def base(demo):
    """The frames without ablations, at every view the groups show."""
    return _frames(demo, "", sorted({v for vs in GROUPS.values()
                                     for v in vs}))


def _frames(demo, ablate, views):
    """{view: (JAX image, port image)} of one configuration."""
    jcfg, jscene, jview, jmeta, scene, view, meta = demo
    jcfg = jcfg.replace(ablate=ablate)
    cfg = TEST_CONFIG.replace(ablate=ablate, **KW)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_frame, "surface_attributes", _noattrs_gather_path)
        for dv in views:
            jv = jview._replace(debug_view=jnp.int32(dv))
            jimg = np.asarray(j_render(jscene, jv, jmeta, jcfg)[0])
            v = view._replace(debug_view=torch.tensor(dv, dtype=torch.int32))
            img, _ = render_frame(scene, v, meta, cfg)
            assert bool(torch.isfinite(img).all())
            out[dv] = (jimg, img.numpy())
    return out


def _off(a, b):
    return float((np.abs(a - b) > 4 / 255).mean())


@pytest.mark.parametrize("ablate", sorted(GROUPS))
def test_ablations_match_jax(demo, base, ablate):
    views = GROUPS[ablate]
    got = _frames(demo, ablate, views)
    for dv in views:
        jimg, img = got[dv]
        assert_golden(img, jimg, f"ablate={ablate!r}, view {dv}")
        assert _off(img, jimg) <= _off(*base[dv][::-1])
        assert not np.array_equal(img, base[dv][1]), (ablate, dv)
    if "noswitch" in ablate:
        # Every debug view shows the lit frame (the skydome stays off in
        # the debug views).
        lit = (got[1][1] != 0).any(-1)
        assert lit.mean() > 0.3
        np.testing.assert_array_equal(got[1][1][lit], got[0][1][lit])
