"""The meshlet path of the frame against the JAX package: live-triangle
compaction (``compact_setup``, ``remap_pair_tri``) bit for bit, and whole
meshlet frames (tests/test_meshlet_render.py's scenes and a reduced bench
config 4 with compaction) against the jitted JAX frame by the golden
criterion.

The JAX frame on the CPU takes the jnp raster, which never compacts; the
port's CPU frame compacts (plain pair walk). Compaction is exact where the
cap exceeds the live count, so frames are compared only there, and
overflow is tested on the two functions directly."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as J_TEST_CONFIG
from zeldaengine_tpu.meshlet import build_meshlets as j_build_meshlets
from zeldaengine_tpu.ops import rasterize_pallas as j_rp
from zeldaengine_tpu.ops.rasterize import TriangleSetup as JSetup
from zeldaengine_tpu.ops.rasterize import (
    rasterize_visibility as j_rasterize_visibility)
from zeldaengine_tpu.passes import build_view_state as j_view
from zeldaengine_tpu.passes import render_frame as j_render
from zeldaengine_tpu.scene import mesh as j_mesh
from zeldaengine_tpu.scene import world as j_world
from zeldaengine_tpu.scene.scenebuild import SceneBuilder as JSceneBuilder
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.meshlet import build_meshlets
from zeldaengine_tpu_torch.ops import rasterize_cuda as rc
from zeldaengine_tpu_torch.ops.rasterize import TriangleSetup
from zeldaengine_tpu_torch.passes import build_view_state, render_frame
from zeldaengine_tpu_torch.passes import frame as t_frame
from zeldaengine_tpu_torch.scene import mesh as t_mesh
from zeldaengine_tpu_torch.scene import world as t_world
from zeldaengine_tpu_torch.scene.scenebuild import SceneBuilder

from _torch_compare import assert_golden

torch.set_num_threads(1)


def _random_setup(seed=0, t=600):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, 100.0, t).astype(np.float32)
    y0 = rng.uniform(0.0, 100.0, t).astype(np.float32)
    return dict(
        edge=rng.normal(size=(t, 3, 3)).astype(np.float32),
        zc=rng.normal(size=(t, 3)).astype(np.float32),
        valid=rng.random(t) < 0.7,
        # Widths from -0.5 (dead) to 3 px, many with no pixel centre.
        bbox=np.stack([x0, y0, x0 + rng.uniform(-0.5, 3.0, t),
                       y0 + rng.uniform(-0.5, 3.0, t)], 1).astype(np.float32),
        zmin=rng.random(t).astype(np.float32))


@pytest.mark.parametrize("center_cull", [False, True])
@pytest.mark.parametrize("cap", ["below", "equal", "above"])
def test_compact_setup_and_remap_match_the_reference(cap, center_cull):
    """Bit for bit at caps below, equal to and above the live count: the
    compacted rows (dead padding rows zeros, id T), the extra payload, the
    original ids, the overflow (highest live ids dropped first), and
    pair_tri remapped to original ids with dead pairs -> T."""
    a = _random_setup()
    t = a["edge"].shape[0]
    extra = np.random.default_rng(1).normal(size=(t, 7)).astype(np.float32)
    js = JSetup(**{k: jnp.asarray(v) for k, v in a.items()})
    ts = TriangleSetup(**{k: torch.from_numpy(v) for k, v in a.items()})
    n_live = int(np.asarray(j_rp.compact_setup(js, t, center_cull=center_cull)
                            [2] < t).sum())
    n = {"below": n_live // 2, "equal": n_live, "above": n_live + 50}[cap]
    want = j_rp.compact_setup(js, n, extra=jnp.asarray(extra),
                              center_cull=center_cull)
    got = rc.compact_setup(ts, n, extra=torch.from_numpy(extra),
                           center_cull=center_cull)
    for name, w, g in zip(JSetup._fields, want[0], got[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for name, w, g in zip(("extra", "idx"), want[1:3], got[1:3]):
        assert g.dtype == torch.float32 if name == "extra" else torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[3]) == int(want[3]) == max(n_live - n, 0)
    # The pairs of the compacted setup, their ids remapped.
    pairs = rc.build_pairs(got[0], 128, 128, 8, 32, expand=4,
                           sort_z=True, ysort_sub_rows=8,
                           center_cull=center_cull)
    assert int((pairs.pair_tri == n).sum()) > 0  # dead pairs present
    remapped = rc.remap_pair_tri(pairs, got[2], t)
    jpairs = collections.namedtuple("Pairs", "pair_tri")(
        jnp.asarray(pairs.pair_tri.numpy()))
    np.testing.assert_array_equal(
        remapped.pair_tri.numpy(),
        np.asarray(j_rp.remap_pair_tri(jpairs, want[2], t).pair_tri))
    assert remapped.pair_tri.dtype == torch.int32


def _light(mod, moon):
    return [mod.LightDesc(position=moon, type=0, intensity=3.0,
                          color=np.float32([1.0, 0.95, 0.85]),
                          direction=moon / np.linalg.norm(moon))]


def _single(bm, mesh, builder):
    """tests/test_meshlet_render.py's meshlet_scene: a meshlet sphere over
    a plane."""
    sphere = mesh.make_sphere(1.0, rings=24, sectors=32)
    builder.add_meshlet_object(
        bm(sphere.positions, sphere.indices, max_triangles=64,
           normals=sphere.normals, uvs=sphere.uvs),
        builder.add_material({}))
    builder.add_object(mesh.make_plane(5.0, z=-1.2), builder.add_material({}))
    return (0.0, -4.0, 1.0), (0.0, 0.0, 0.0), (10.0, -10.0, 20.0), 60.0


def _instanced(bm, mesh, builder):
    """tests/test_meshlet_render.py::test_meshlet_instanced_object: one
    baked sphere, three instances (one yawed, one half scale)."""
    sphere = mesh.make_sphere(0.5, rings=12, sectors=16)
    inst = np.zeros((3, 8), np.float32)
    inst[:, 0] = [-1.5, 0.0, 1.5]
    inst[:, 4] = [0.0, 1.0, 0.0]
    inst[:, 6] = [1.0, 1.0, 0.5]
    builder.add_meshlet_object(
        bm(sphere.positions, sphere.indices, max_triangles=64,
           normals=sphere.normals, uvs=sphere.uvs),
        builder.add_material({}), instances=inst)
    return (0.0, -5.0, 0.5), (0.0, 0.0, 0.0), (10.0, -10.0, 20.0), 60.0


def _config4(bm, mesh, builder):
    """bench.py:254-334 cut to the 4 middle spheres of its 4x4 grid, of
    4,800 triangles each, at the test size: the camera and moon of
    bench.py's make_world, config 4's options, compaction caps above the
    live count and below the pool."""
    sphere = mesh.make_sphere(0.8, rings=40, sectors=60)
    mat = builder.add_material({})
    for i in (5, 6, 9, 10):
        offs = np.float32([(i % 4 - 1.5) * 2.2, (i // 4 - 1.5) * 2.2, 0.8])
        builder.add_meshlet_object(bm(
            sphere.positions + offs, sphere.indices, normals=sphere.normals,
            uvs=sphere.uvs), mat)
    return (6.0, -6.0, 3.0), (0.0, 0.0, 0.8), (20.0, 0.0, 20.0), 80.0


_CONFIG4 = dict(pair_expand=4, pair_expand_shadow=2, compact_tris=12288,
                compact_tris_shadow=8192, shadow_cone_cull=True,
                subpixel_cull=True, max_pairs=96 * 1024,
                max_pairs_shadow=64 * 1024, tile_h=32, tile_w=128)
_SCENES = {"single": (_single, {}), "instanced": (_instanced, {}),
           "config4-reduced": (_config4, _CONFIG4)}


def _build(name, port: bool, **config_changes):
    """The scene, meta, view and config of one case in one package."""
    make, opts = _SCENES[name]
    cfg = (TEST_CONFIG if port else J_TEST_CONFIG).replace(
        **{**opts, **config_changes})
    builder = (SceneBuilder if port else JSceneBuilder)(cfg)
    if name != "config4-reduced":
        builder.enable_skydome = False
    eye, at, moon, z_far = make(build_meshlets if port else j_build_meshlets,
                                t_mesh if port else j_mesh, builder)
    scene, meta = builder.build("cpu") if port else builder.build()
    mod = t_world if port else j_world
    w = mod.World()
    w.enable_skydome = name == "config4-reduced"
    w.main_camera = mod.CameraDesc(position=np.float32(eye),
                                   lookat=np.float32(at), z_far=z_far)
    w.directional_lights = _light(mod, np.float32(moon))
    kw = dict(light_capacities=(2, 2, 2), animate_point_lights=False)
    view = (build_view_state(w, cfg, device="cpu", **kw) if port
            else j_view(w, cfg, **kw))
    return scene, view, meta, cfg


def _render_noting_setups(scene, view, meta, cfg):
    """The port's frame, and the shadow and deferred passes' triangle
    setups as the frame built them (before compaction: original rows; bit
    for bit with the jitted JAX setups)."""
    captured = []
    real = t_frame.triangle_setup

    def note(*args, **kw):
        captured.append(real(*args, **kw))
        return captured[-1]

    t_frame.triangle_setup = note
    try:
        out = render_frame(scene, view, meta, cfg)
    finally:
        t_frame.triangle_setup = real
    sh, gb = captured
    return out, gb, sh


def _assert_equal_but_outside_bbox(depth, jdepth, tid, jtid, setup):
    """Depth (and ids) equal, but at exact depth ties and where the JAX
    package's winner lies outside its own bbox (the sliver deviation)."""
    differs = depth != jdepth
    if tid is not None:
        differs |= tid != jtid
    ys, xs = np.nonzero(differs)
    assert len(ys) <= 4, len(ys)
    bbox = setup.bbox.numpy()
    for y, x in zip(ys, xs):
        x0, y0, x1, y1 = bbox[max(jtid[y, x], 0)]
        outside = not (x0 <= x + 0.5 <= x1 and y0 <= y + 0.5 <= y1)
        assert depth[y, x] == jdepth[y, x] or (jtid[y, x] >= 0 and outside)


@pytest.fixture(scope="module")
def frames():
    out = {}
    for name in _SCENES:
        scene, view, meta, cfg = _build(name, port=True)
        assert meta.has_meshlets
        frame, gb, sh = _render_noting_setups(scene, view, meta, cfg)
        out[name] = (scene, view, meta, cfg, frame, gb, sh)
    return out


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_meshlet_frames_match_the_jitted_reference(frames, name):
    """The two packages build the same meshlet scene, and each frame meets
    the golden criterion against the jitted JAX frame;
    the GBuffer depth and triangle ids are equal but at exact depth ties
    and at pixels where the JAX package's jnp raster gives a sliver
    triangle far outside its own bbox (ROADMAP.md C), and so is the shadow
    map (the JAX package's shadow raster is the jnp raster too: its winners
    are found by ``rasterize_visibility`` on the same setup); at most 4
    such pixels or texels. Nothing overflowed (the reduced config 4 really
    compacts: its caps are below the pool). The final depth of sky pixels
    (the analytic dome's) is not compared."""
    scene, view, meta, cfg, (img, aux), gb, sh = frames[name]
    jscene, jview, jmeta, jcfg = _build(name, port=False)
    # The port's SceneBuilder.add_meshlet_object builds the same scene.
    for leaf in ("meshlet_records", "tri_meshlet", "tri_vtx", "tri_valid",
                 "pair_pos"):
        np.testing.assert_array_equal(getattr(scene, leaf).numpy(),
                                      np.asarray(getattr(jscene, leaf)),
                                      err_msg=leaf)
    jimg, jaux = j_render(jscene, jview, jmeta, jcfg)
    assert_golden(img.numpy(), np.asarray(jimg), name)
    _assert_equal_but_outside_bbox(
        aux["gbuffer_depth"].numpy(), np.asarray(jaux["gbuffer_depth"]),
        aux["tri_id"].numpy(), np.asarray(jaux["tri_id"]), gb)
    jsh = JSetup(**{k: None if v is None else jnp.asarray(v.numpy())
                    for k, v in sh._asdict().items()})
    jdepth, jtid = j_rasterize_visibility(jsh, cfg.shadowmap_dim,
                                          cfg.shadowmap_dim,
                                          chunk=cfg.tri_chunk)
    np.testing.assert_array_equal(np.asarray(jdepth),
                                  np.asarray(jaux["shadowmap"]))
    _assert_equal_but_outside_bbox(
        aux["shadowmap"].numpy(), np.asarray(jdepth), None,
        np.asarray(jtid), sh)
    assert int(aux["pair_overflow"]) == 0 and int(aux["compact_overflow"]) == 0
    tid = aux["tri_id"].numpy()
    assert tid[cfg.height // 2, cfg.width // 2] >= 0
    if name == "config4-reduced":
        t = scene.tri_vtx.shape[0]
        assert cfg.compact_tris < t and cfg.compact_tris_shadow < t
    # Culling removes work: far fewer meshlets drawn than exist.
    drawn = np.unique(scene.tri_meshlet.numpy()[np.unique(tid[tid >= 0])])
    assert 0 < (drawn >= 0).sum() < meta.num_meshlets


@pytest.mark.parametrize("name", ["single", "config4-reduced"])
def test_cull_changes_no_pixel(frames, name):
    """The reference's own property (test_meshlet_render.py): with every
    meshlet id erased (-1: never culled) the frame's ids and colours are
    the same. The compaction caps are sized for the culled set, so both
    frames run without them (compaction is exact below its cap), and
    without the light-apex cone test: it is not exact (the slope-scaled
    depth bias can put a light-facing surface behind a culled back face;
    248 texels of the reduced config 4's map, in both packages, ROADMAP.md
    C)."""
    scene, view, meta, cfg = frames[name][:4]
    cfg = cfg.replace(compact_tris=None, compact_tris_shadow=None,
                      shadow_cone_cull=False)
    img, aux = render_frame(scene, view, meta, cfg)
    uncut = scene._replace(tri_meshlet=torch.full_like(scene.tri_meshlet, -1))
    img2, aux2 = render_frame(uncut, view, meta, cfg)
    assert int(aux2["pair_overflow"]) == 0
    np.testing.assert_array_equal(aux2["tri_id"].numpy(), aux["tri_id"].numpy())
    np.testing.assert_allclose(img2.numpy(), img.numpy(), atol=1e-6)


def test_compaction_cap_below_the_live_count_counts_its_overflow(frames):
    """With caps below the live counts the frame still renders; the
    triangles the caps dropped are in ``compact_overflow`` and in
    ``pair_overflow``, as ``compact_setup`` counts them."""
    scene, view, meta, cfg = frames["config4-reduced"][:4]
    small = cfg.replace(compact_tris=1024, compact_tris_shadow=512)
    img, aux = render_frame(scene, view, meta, small)
    assert bool(torch.isfinite(img).all())
    ovf = int(aux["compact_overflow"])
    assert ovf > 0 and int(aux["pair_overflow"]) >= ovf
    covered = int((aux["tri_id"] >= 0).sum())
    full = int((frames["config4-reduced"][4][1]["tri_id"] >= 0).sum())
    assert 0 < covered < full
