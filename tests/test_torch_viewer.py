"""The port's live HTTP viewer and pass profiler, as tests/test_viewer.py
and tests/test_profiling.py hold the JAX package's: the page, the MJPEG
frames, browser input onto the engine, resize through input and at run
time, the editor panels, and the stage breakdown of profile_passes."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import zeldaengine_tpu_torch.scene.world as tworld
from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.engine import Engine
from zeldaengine_tpu_torch.passes import build_view_state
from zeldaengine_tpu_torch.profiling import profile_passes
from zeldaengine_tpu_torch.scene import build_demo_scene
from zeldaengine_tpu_torch.viewer import EngineViewer

from _torch_shell import small_world

torch.set_num_threads(1)

_CONFIG = TEST_CONFIG.replace(enable_shadow=False, enable_skydome=False,
                              frames_in_flight=1)


@pytest.fixture(scope="module")
def viewer():
    e = Engine(config=_CONFIG, world=small_world(tworld), livelink_port=None,
               device="cpu")
    v = EngineViewer(e, port=0, max_fps=10.0)
    v.start()
    yield v
    v.stop()


def _get(viewer, path, timeout=60.0):
    return urllib.request.urlopen(
        f"http://localhost:{viewer.port}{path}", timeout=timeout).read()


def _post(viewer, path, msg, timeout=60.0):
    req = urllib.request.Request(
        f"http://localhost:{viewer.port}{path}",
        data=json.dumps(msg).encode(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def test_viewer_serves_page_frames_and_stats(viewer):
    assert viewer.port != 0  # port 0 bound a free port and reported it
    page = _get(viewer, "/")
    assert b"/stream" in page and b"zeldaengine_tpu_torch" in page
    frame = _get(viewer, "/frame.jpg")
    assert frame[:2] == b"\xff\xd8"  # JPEG SOI
    stats = json.loads(_get(viewer, "/stats"))
    assert stats["frame_index"] >= 1
    assert set(stats) == {"frame_index", "frame_ms", "fps", "triangles",
                          "reloads", "presents_dropped", "pass_ms",
                          "validation"}


def test_viewer_input_reaches_the_engine(viewer):
    """Browser events land on the Engine's input surface (orbit drag,
    keys 0-9 / F R G M L, zoom); an unknown event is an error reply."""
    e = viewer.engine
    before = np.asarray(e.world.main_camera.position).copy()
    assert _post(viewer, "/input", {"type": "orbit", "dx": 40, "dy": 0})["ok"]
    assert not np.allclose(before, np.asarray(e.world.main_camera.position))
    assert _post(viewer, "/input", {"type": "key", "key": "3"})["ok"]
    assert e.debug_view == 3
    _post(viewer, "/input", {"type": "key", "key": "0"})
    for key, attr in (("M", "play_stage_roll"), ("L", "play_light_roll"),
                      ("G", "game_mode")):
        was = getattr(e, attr)
        _post(viewer, "/input", {"type": "key", "key": key})
        assert getattr(e, attr) is (not was), key
        _post(viewer, "/input", {"type": "key", "key": key})
    arm = e.world.main_camera.arm_length
    assert _post(viewer, "/input", {"type": "zoom", "d": 1})["ok"]
    assert e.world.main_camera.arm_length != arm
    with pytest.raises(urllib.error.HTTPError):
        _post(viewer, "/input", {"type": "teleport"})


def test_resize_through_input_and_at_run_time(viewer):
    """Frames keep streaming after a resize through input; one engine
    lifetime renders two resolutions, at two frames in flight too. A
    resize that lands while a frame renders leaves that tick its own
    frame, and the next tick presents the new size."""
    assert _post(viewer, "/input", {"type": "resize", "width": 128,
                                    "height": 64})["ok"]
    assert viewer.engine.config.height == 64
    assert _get(viewer, "/frame.jpg")[:2] == b"\xff\xd8"
    _post(viewer, "/input", {"type": "resize", "width": _CONFIG.width,
                             "height": _CONFIG.height})
    e = Engine(config=_CONFIG.replace(frames_in_flight=2,
                                      present_mode="fifo"),
               world=small_world(tworld), livelink_port=None, device="cpu")
    assert e.tick().shape[:2] == (_CONFIG.height, _CONFIG.width)
    e.resize(64, 96)  # (width, height)
    assert e.tick().shape[:2] == (96, 64)  # the first frame since the drop
    assert e.tick().shape[:2] == (96, 64)

    def resize_during_render(img, drains):
        del e._present_async
        e.resize(_CONFIG.width, _CONFIG.height)
        return e._present_async(img, drains)

    e._present_async = resize_during_render
    assert e.tick().shape[:2] == (96, 64)
    assert e.tick().shape[:2] == (_CONFIG.height, _CONFIG.width)
    e.stop()


def test_failed_fetch_stops_the_viewer():
    """A present fetch that fails ends the render loop: /frame.jpg and
    /stats answer 500 with the error, no tick retries, and stop() raises
    it."""
    e = Engine(config=_CONFIG.replace(frames_in_flight=2,
                                      present_mode="fifo"),
               world=small_world(tworld), livelink_port=None, device="cpu")
    calls = []

    def broken_fetch(item):
        calls.append(item)
        raise OSError("device lost")

    e._fetch = broken_fetch
    v = EngineViewer(e, port=0, max_fps=10.0)
    v.start()
    try:
        v._render_thread.join(timeout=120.0)
        assert not v._render_thread.is_alive()
        for path in ("/frame.jpg", "/stats"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(v, path)
            assert err.value.code == 500
            assert b"frame fetch failed" in err.value.read(), path
        time.sleep(0.3)
        assert len(calls) == 1 and e.stats.frame_index == 0
    finally:
        with pytest.raises(RuntimeError) as err:
            v.stop()
        e.stop()
    cause = err.value.__cause__
    assert "frame fetch failed" in str(cause)
    assert isinstance(cause.__cause__, OSError)


def test_viewer_editor_panels_and_commands(viewer, tmp_path):
    """The page holds the editor panels (outliner, details, menu, Python
    IDE); /editor speaks the editor protocol."""
    page = _get(viewer, "/").decode()
    for marker in ("Outliner", "Details", "Python IDE", "Compile Shaders",
                   "/editor", "grid-template-columns"):
        assert marker in page, marker
    out = _post(viewer, "/editor", {"Command": "GetOutliner"})
    assert out["Status"] == "ok" and out["Lights"]["Directional"] == 1
    assert [o["ProfabName"] for o in out["Objects"]] == ["terrain", "rock_02"]
    r = _post(viewer, "/editor", {
        "Command": "SetDetails", "Target": "DirectionalLight/0",
        "Values": {"color": [0.25, 0.5, 0.75]}})
    assert r["Status"] == "ok" and "color" in r["Applied"]
    assert np.allclose(viewer.engine.world.directional_lights[0].color,
                       [0.25, 0.5, 0.75])
    path = str(tmp_path / "World.json")
    assert _post(viewer, "/editor", {"Command": "SaveWorld",
                                     "Path": path})["Status"] == "ok"
    assert "MainCamera" in json.loads(open(path).read())
    r = _post(viewer, "/editor", {"Command": "RunScript",
                                  "Source": "print(engine.stats.triangles)"})
    assert r["Status"] == "ok" and r["Output"].strip().isdigit()


@pytest.mark.parametrize("enable", [True, False])
def test_profile_passes_reports_every_stage(enable):
    """The JAX package's stage keys, each finite and >= 0; shadow, pcf
    and sky only where the config enables them."""
    cfg = TEST_CONFIG.replace(enable_shadow=enable, enable_skydome=enable,
                              point_light_kernel="unroll")
    scene, meta, world = build_demo_scene(cfg, grass=8, rocks=4,
                                          device="cpu")
    view = build_view_state(world, cfg, light_capacities=(2, 8, 2),
                            device="cpu")
    out = profile_passes(scene, view, meta, cfg, reps=1)
    want = {"null", "vertex", "raster", "attrs", "lighting", "full",
            "sum_of_parts"}
    if enable:
        want |= {"shadow", "pcf", "sky"}
    assert set(out) == want
    for key, ms in out.items():
        assert np.isfinite(ms) and ms >= 0.0, key
    e = Engine(config=cfg, world=small_world(tworld), livelink_port=None,
               device="cpu")
    assert set(e.profile_passes(reps=1)) == want
    assert set(e.stats.pass_ms) == want
