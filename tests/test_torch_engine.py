"""The port's engine shell against the JAX package's: the stage roll's
model matrix, the frames both engines present under one input script and
one clock, the present modes, the defaults, and the validation counters.

One JAX engine carries the whole input script (each config it reaches
compiles once); both engines read one fake clock through their module's
``time``."""

import inspect
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import zeldaengine_tpu.engine as jengine
import zeldaengine_tpu.scene.world as jworld
import zeldaengine_tpu_torch.engine as tengine
import zeldaengine_tpu_torch.scene.world as tworld
from zeldaengine_tpu.config import TEST_CONFIG as J_TEST_CONFIG
from zeldaengine_tpu.math.transforms import rotate_z as j_rotate_z
from zeldaengine_tpu.passes import build_view_state as j_build_view_state
from zeldaengine_tpu.passes import render_frame as j_render_frame
from zeldaengine_tpu.passes.frame import render_rows
from zeldaengine_tpu.passes.view import _view_matrices as j_view_matrices
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.math.transforms import rotate_z
from zeldaengine_tpu_torch.passes import build_view_state, render_frame
from zeldaengine_tpu_torch.passes.view import _view_matrices

from _torch_shell import FakeClock, small_world, u8_frame_diff

torch.set_num_threads(1)

j_render_rows = jax.jit(render_rows, static_argnames=("meta", "config"))

TICK_S = 1.0 / 30.0
# The input script: (step, what it does to an engine before its tick).
# Steps that drop the frames in flight (a present drain) are marked True.
SCRIPT = [
    ("start", lambda e: None, True),
    ("orbit", lambda e: e.orbit(20.0, 10.0), False),
    ("zoom", lambda e: e.zoom(1.0), False),
    ("focus", lambda e: e.focus((0.3, -0.2, 0.0)), False),
    ("debug_view", lambda e: e.set_debug_view(4), False),
    ("debug_view_0", lambda e: e.set_debug_view(0), False),
    ("roughness", lambda e: e.set_material_override(roughness=0.5), False),
    ("stage_roll", lambda e: e.toggle_stage_roll(), False),
    ("stage_roll_moves", lambda e: None, False),
    ("light_roll", lambda e: e.toggle_light_roll(), False),
    ("game_mode", lambda e: e.toggle_game_mode(), False),
    ("gbuffer_vis_with_bars", lambda e: e.set_debug_view(9), False),
    ("back_to_view_0", lambda e: e.set_debug_view(0), False),
    ("resize", lambda e: e.resize(96, 64), True),
    ("wireframe", lambda e: e.set_wireframe(True), True),
    ("wireframe_moves", lambda e: None, False),
]


def _angles():
    rng = np.random.default_rng(8)
    return np.concatenate([
        rng.uniform(-7.0, 40.0, 400),             # negative and > 2 pi
        np.arange(-8, 9) * (np.pi / 2),           # multiples of pi / 2
        np.arange(0.0, 20.0, 0.25),               # the roll's 15 deg/s steps
        [1e4, -3e5, 1e7],                         # a roll that ran for days
    ]).astype(np.float32)


def test_rotate_z_matches_jitted_reference():
    """Bit for bit with the jitted rotate_z and with the model matrix of
    the jitted _view_matrices, whose sin / cos XLA lowers to the C
    library's sinf / cosf."""
    jit_rotate = jax.jit(j_rotate_z)
    eye = np.float32([3.0, -4.0, 2.0])
    center = np.float32([0.0, 0.0, 0.5])
    light = np.float32([20.0, 0.0, 20.0])
    angles = _angles()
    for a in angles:
        want = np.asarray(jit_rotate(jnp.float32(a)))
        got = rotate_z(np.float32(a)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=str(a))
    for a in angles[::7]:
        want = np.asarray(j_view_matrices(eye, center, light, 0.785, 1.5,
                                          0.1, 100.0, np.float32(a))[2])
        got = _view_matrices(eye, center, light, 0.785, 1.5, 0.1, 100.0,
                             np.float32(a))[2].numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=str(a))


@pytest.fixture(scope="module")
def scripted_frames():
    """The input script on the JAX engine (one frame in flight: the
    reference's pipelined present returns whichever frame its fetch
    thread finished last) and on the port's engines at one and two
    frames in flight, in lockstep on one clock. Returns ({engine: frames
    presented}, {engine: (render_frame arguments, shadow map) of each
    tick})."""
    clock = FakeClock()
    calls = {}
    ticking = []  # the name of the engine whose tick is running

    def noting(render):
        def wrapped(scene, view, meta, config):
            color, aux = render(scene, view, meta, config)
            calls.setdefault(ticking[-1], []).append(
                ((scene, view, meta, config), np.asarray(aux["shadowmap"])))
            return color, aux
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "time", clock)
        mp.setattr(tengine, "time", clock)
        mp.setattr(jengine, "render_frame", noting(jengine.render_frame))
        mp.setattr(tengine, "render_frame", noting(tengine.render_frame))
        config = TEST_CONFIG.replace(present_mode="fifo")
        engines = {
            "jax": jengine.Engine(
                config=J_TEST_CONFIG.replace(present_mode="fifo",
                                             frames_in_flight=1),
                world=small_world(jworld), livelink_port=None),
            "port_fif1": tengine.Engine(
                config=config.replace(frames_in_flight=1),
                world=small_world(tworld), livelink_port=None,
                device="cpu"),
            "port_fif2": tengine.Engine(
                config=config.replace(frames_in_flight=2),
                world=small_world(tworld), livelink_port=None,
                device="cpu"),
        }
        frames = {name: [] for name in engines}
        for _step, act, _drain in SCRIPT:
            clock.now += TICK_S
            for name, e in engines.items():
                act(e)
                ticking.append(name)
                frames[name].append(e.tick())
        for e in engines.values():
            e.stop()
    return frames, calls


def _sliver_texels(args, jax_map, port_map):
    """The shadow-map texels where the two packages differ, each checked
    to be the deviation of ROADMAP.md section C: the JAX package's jnp
    raster accepts a texel for a sliver triangle whose three edge values
    lie within rounding of zero far outside its bbox; the port's pair
    rasterizer visits only the tiles of a pair's bbox and keeps the depth
    behind. Returns the number of such texels."""
    from zeldaengine_tpu_torch.math.transforms import (
        apply_mat4_h, apply_mat4_point)
    from zeldaengine_tpu_torch.ops import pbr
    from zeldaengine_tpu_torch.ops.rasterize import (
        edge_value, triangle_setup)

    scene, view, _meta, cfg = args
    n_p = scene.pair_pos.shape[0]
    world = apply_mat4_point(view.model, torch.cat(
        [scene.pair_pos, pbr.normalize(scene.pair_nrm)]))[:n_p]
    clip = apply_mat4_h(view.shadow_space, world)
    setup = triangle_setup(
        clip[scene.tri_vtx.long()], cfg.shadowmap_dim, cfg.shadowmap_dim,
        two_sided=True, valid_mask=scene.tri_valid,
        depth_bias=(cfg.shadow_bias_constant, cfg.shadow_bias_slope))
    ys, xs = np.nonzero(jax_map != port_map)
    for y, x in zip(ys, xs):
        assert jax_map[y, x] < port_map[y, x], (y, x)
        px = torch.tensor(x + 0.5, dtype=torch.float32)
        py = torch.tensor(y + 0.5, dtype=torch.float32)
        e = setup.edge
        inside = (edge_value(e[:, :, 0], e[:, :, 1], e[:, :, 2], px, py)
                  >= 0).all(1) & setup.valid
        b = setup.bbox
        outside_bbox = (b[:, 0] > px) | (b[:, 2] < px) | (b[:, 1] > py) \
            | (b[:, 3] < py)
        assert bool((inside & outside_bbox).any()), (y, x)
    return len(ys)


@pytest.mark.parametrize("fif", [1, 2])
def test_engine_matches_reference_under_input_script(scripted_frames, fif):
    """Every presented frame of the port's engine against the JAX
    engine's frame of the same clock and input: no value off by more
    than 4 (u8), at most 0.1 % off by more than 1 (the last-bit shading
    contractions of ROADMAP.md section C). At two frames in flight tick n
    presents frame n - 1 (config.py: frames_in_flight), or its own frame
    right after a drain (start, resize, wireframe toggle).

    Where the two shadow maps differ, each differing texel must be the
    documented sliver deviation of the JAX package's raster, and the
    frame is held to the same criterion against the JAX frame rendered
    with the port's shadow map."""
    frames, calls = scripted_frames
    name = f"port_fif{fif}"
    want, got = frames["jax"], frames[name]
    assert len(got) == len(want) == len(SCRIPT)
    slivers = 0
    for k, (step, _act, drain) in enumerate(SCRIPT):
        shown = k if (fif == 1 or drain) else k - 1
        ref = want[shown]
        (j_args, j_map), (t_args, t_map) = calls["jax"][shown], \
            calls[name][shown]
        if not np.array_equal(j_map, t_map):
            slivers += _sliver_texels(t_args, j_map, t_map)
            scene, view, meta, cfg = j_args
            color, _ = j_render_rows(scene, view, meta, cfg,
                                     shadowmap_override=jnp.asarray(t_map))
            ref = np.asarray(jengine._present_u8(color))
        worst, share = u8_frame_diff(got[k], ref)
        assert worst <= 4 and share <= 0.001, (step, worst, share)
    assert slivers <= 4
    # The script moved the frame: the roll, the views, resize, wireframe.
    assert got[-1].shape == (64, 96, 3)
    assert not np.array_equal(want[7], want[8])  # the stage roll moves
    assert not np.array_equal(want[13], want[14])  # wireframe


def test_mailbox_never_blocks_and_counts_drops():
    """Under mailbox a tick never waits for the host copy: with the fetch
    held, five ticks return (the newest fetched frame), the full queue
    drops its stalest frames, and every rendered frame is either fetched
    or dropped."""
    eng = tengine.Engine(
        config=TEST_CONFIG.replace(width=64, height=64, shadowmap_dim=64,
                                   present_mode="mailbox",
                                   frames_in_flight=2),
        world=small_world(tworld), livelink_port=None, device="cpu")
    gate = threading.Event()
    gate.set()
    fetched = []
    real_fetch = eng._fetch

    def held_fetch(item):
        assert gate.wait(timeout=120.0)
        fetched.append(item)
        return real_fetch(item)

    eng._fetch = held_fetch
    eng.toggle_stage_roll()  # every frame differs from the one before
    first = eng.tick()
    deadline = time.time() + 60.0
    while eng._present_q.unfinished_tasks and time.time() < deadline:
        time.sleep(0.01)
    gate.clear()
    shown = []
    ticker = threading.Thread(
        target=lambda: shown.extend(eng.tick() for _ in range(5)))
    ticker.start()
    ticker.join(timeout=120.0)
    assert not ticker.is_alive(), "a mailbox tick waited for the fetch"
    assert len(shown) == 5
    assert all(np.array_equal(img, first) for img in shown)
    assert eng.stats.presents_dropped >= 2
    gate.set()
    deadline = time.time() + 60.0
    while eng._present_q.unfinished_tasks and time.time() < deadline:
        time.sleep(0.01)
    assert eng._present_q.unfinished_tasks == 0
    assert eng.stats.frame_index == len(fetched) + eng.stats.presents_dropped
    later = eng.tick()
    assert not np.array_equal(later, first)
    eng.stop()


def test_engine_defaults_match_reference():
    """Engine() takes EngineConfig() as it is (two frames in flight,
    mailbox), livelink on 8080, light roll off - the JAX engine's
    defaults - and runs on the card unless asked for the CPU."""
    for param in ("config", "world", "asset_roots", "livelink_port"):
        assert (inspect.signature(tengine.Engine).parameters[param].default
                == inspect.signature(jengine.Engine).parameters[param]
                .default), param
    assert inspect.signature(tengine.Engine).parameters["device"].default \
        == "cuda"
    assert inspect.signature(tengine.Engine.tick).parameters.keys() \
        == {"self"}
    port = tengine.Engine(world=small_world(tworld), device="cpu")
    ref = jengine.Engine(world=small_world(jworld))
    assert port.config == EngineConfig()
    assert (port.config.frames_in_flight, port.config.present_mode) \
        == (ref.config.frames_in_flight, ref.config.present_mode) \
        == (2, "mailbox")
    for attr in ("debug_view", "play_stage_roll", "play_light_roll",
                 "roll_stage", "roll_light", "game_mode",
                 "editor_right_frac", "editor_bottom_frac"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    np.testing.assert_array_equal(port.material_overrides,
                                  ref.material_overrides)
    assert port.server.port == ref.server.port == 8080  # not bound yet
    assert port.meta.num_triangles == ref.meta.num_triangles


def _validation_scene(scenebuild_mod, mesh_mod, cfg, device=None):
    """tests/test_validation.py::_scene in either package."""
    b = scenebuild_mod.SceneBuilder(cfg)
    b.add_object(mesh_mod.make_plane(6.0), b.add_material({}), deferred=True)
    b.add_object(mesh_mod.make_cube(1.0, center=(0, 0, 0.5)),
                 b.add_material({}), deferred=True)
    return b.build() if device is None else b.build(device)


def _validation_world(world_mod, n_point=1, intensity=5.0):
    """tests/test_validation.py::_world in either package."""
    w = world_mod.World()
    w.main_camera = world_mod.CameraDesc(
        position=np.array([3.0, -3.0, 2.5], np.float32),
        lookat=np.array([0.0, 0.0, 0.5], np.float32),
    )
    sun = np.array([20.0, 0.0, 20.0], np.float32)
    w.directional_lights = [
        world_mod.LightDesc(position=sun, type=0, intensity=4.0,
                            direction=sun / np.linalg.norm(sun))]
    rng = np.random.RandomState(0)
    for _ in range(n_point):
        w.point_lights.append(world_mod.LightDesc(
            position=np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), 1.0],
                              np.float32),
            type=1, intensity=intensity, radius=4.0,
            color=np.array([1.0, 0.5, 0.2], np.float32),
        ))
    return w


# tests/test_validation.py's cases: (config changes, world keywords, light
# capacities, the counter the case trips). "unroll" on both sides: the
# JAX package's CPU frame culls its 80 lights to light tiles, and so does
# the port's with "unroll" (its "auto" takes the kernel's blocks).
_VALIDATION_CASES = {
    "clean": (dict(), dict(), (2, 2, 2), None),
    "nonfinite_color": (dict(), dict(intensity=float("inf")), (2, 2, 2),
                        "nonfinite_color"),
    "light_drops": (dict(max_tile_lights=1, max_point_lights=128,
                         adaptive_light_capacity=False), dict(n_point=80),
                    (2, 128, 2), "light_drops"),
    "oversized_tris": (dict(pair_expand=1), dict(), (2, 2, 2), None),
}


@pytest.mark.parametrize("cases", [("clean", "nonfinite_color"),
                                   ("light_drops", "oversized_tris")])
def test_validation_counters_match_reference(cases):
    """aux["validation"] of the port's frame equals the JAX package's on
    tests/test_validation.py's cases, counter for counter; and
    count_oversized on its synthetic full-screen triangle. (Two cases a
    test: the file holds at most seven, see test_torch_no_jax.py.)"""
    for case in cases:
        _check_validation_case(case)


def _check_validation_case(case):
    import zeldaengine_tpu.scene.mesh as jmesh
    import zeldaengine_tpu.scene.scenebuild as jbuild
    import zeldaengine_tpu_torch.scene.mesh as tmesh
    import zeldaengine_tpu_torch.scene.scenebuild as tbuild

    changes, world_kw, caps, tripped = _VALIDATION_CASES[case]
    changes = dict(changes, validation=True, point_light_kernel="unroll")
    jcfg = J_TEST_CONFIG.replace(**changes)
    tcfg = TEST_CONFIG.replace(**changes)
    jscene, jmeta = _validation_scene(jbuild, jmesh, jcfg)
    jview = j_build_view_state(_validation_world(jworld, **world_kw), jcfg,
                               light_capacities=caps)
    _, jaux = j_render_frame(jscene, jview, jmeta, jcfg)
    want = {k: int(v) for k, v in jaux["validation"].items()}
    tscene, tmeta = _validation_scene(tbuild, tmesh, tcfg, device="cpu")
    tview = build_view_state(_validation_world(tworld, **world_kw), tcfg,
                             light_capacities=caps, device="cpu")
    _, taux = render_frame(tscene, tview, tmeta, tcfg)
    got = {k: int(v) for k, v in taux["validation"].items()}
    assert got == want
    if tripped is not None:
        assert got[tripped] > 0
    if case == "oversized_tris":
        from zeldaengine_tpu.ops.rasterize import triangle_setup as j_setup
        from zeldaengine_tpu.ops.rasterize_pallas import (
            count_oversized as j_count)
        from zeldaengine_tpu_torch.ops.rasterize import triangle_setup
        from zeldaengine_tpu_torch.ops.rasterize_cuda import count_oversized

        w, h = 1024, 512  # 8x2 supertiles at tile 8x128
        clip = np.float32([[[-4.0, -4.0, 0.5, 1.0], [4.0, -4.0, 0.5, 1.0],
                            [0.0, 8.0, 0.5, 1.0]]])
        n_want = int(j_count(j_setup(jnp.asarray(clip), w, h,
                                     two_sided=True),
                             w, h, tcfg.tile_h, tcfg.tile_w, expand=1))
        n_got = int(count_oversized(
            triangle_setup(torch.from_numpy(clip), w, h, two_sided=True),
            w, h, tcfg.tile_h, tcfg.tile_w, expand=1))
        assert n_got == n_want == 1
