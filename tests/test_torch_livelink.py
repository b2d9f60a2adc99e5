"""The port's livelink and editor protocol against the JAX package's: the
wire format across packages in both directions, streamed world reloads
into the port's engine, every editor command's reply, and the contract
that an edit presents one tick later at two frames in flight.

Every socket binds port 0 and reads the bound port back (the JAX
package's own tests hold fixed ports, and xdist runs files at once)."""

import json
import time

import numpy as np
import pytest
import torch

import zeldaengine_tpu.engine as jengine
import zeldaengine_tpu.livelink as jlivelink
import zeldaengine_tpu.scene.world as jworld
import zeldaengine_tpu_torch.engine as tengine
import zeldaengine_tpu_torch.livelink as tlivelink
import zeldaengine_tpu_torch.scene.world as tworld
from zeldaengine_tpu.config import TEST_CONFIG as J_TEST_CONFIG
from zeldaengine_tpu_torch import TEST_CONFIG

from _torch_shell import FakeClock, small_world

torch.set_num_threads(1)


def _bound_port(server) -> int:
    """The port a started server listens on (the JAX package's server
    keeps the 0 it was given)."""
    return server._sock.getsockname()[1]


def _wait_pending(server, timeout=30.0) -> None:
    deadline = time.time() + timeout
    while server._pending is None and time.time() < deadline:
        time.sleep(0.01)
    assert server._pending is not None, "the push did not arrive"


@pytest.mark.parametrize("direction", ["jax_client_to_port_server",
                                       "port_client_to_jax_server"])
def test_wire_format_across_packages(direction):
    """One JSON document per connection: a document with a "Command" key
    is dispatched and its reply written back; anything else (a world, bad
    JSON) is kept for the render loop as sent, larger than one
    RECV_BUFFER read included."""
    assert tlivelink.server.RECV_BUFFER == jlivelink.server.RECV_BUFFER \
        == 65720
    if direction == "jax_client_to_port_server":
        server_mod, client = tlivelink, jlivelink
    else:
        server_mod, client = jlivelink, tlivelink
    server = server_mod.LivelinkServer(
        port=0, on_command=lambda msg: {"Echo": msg["Command"],
                                        "Status": "ok"})
    server.start()
    try:
        port = _bound_port(server)
        assert port != 0
        world = small_world(tworld).to_json()
        world["Padding"] = "x" * 100_000  # three reads of RECV_BUFFER
        client.send_data_to_engine(world, port=port)
        _wait_pending(server)
        assert json.loads(server.poll()) == world
        assert server.poll() is None
        reply = client.editor_request({"Command": "GetStats"}, port=port)
        assert reply == {"Echo": "GetStats", "Status": "ok"}
        client.send_data_to_engine("{not json", port=port)
        _wait_pending(server)
        assert server.poll() == "{not json"
    finally:
        server.stop()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX engine (one frame in flight) and the port's engine (fifo,
    two frames in flight) on one small world and one clock, their
    livelink servers started on free ports, ticked once each."""
    clock = FakeClock()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "time", clock)
        mp.setattr(tengine, "time", clock)
        ref = jengine.Engine(
            config=J_TEST_CONFIG.replace(present_mode="fifo",
                                         frames_in_flight=1),
            world=small_world(jworld), livelink_port=0)
        port = tengine.Engine(
            config=TEST_CONFIG.replace(present_mode="fifo",
                                       frames_in_flight=2),
            world=small_world(tworld), livelink_port=0, device="cpu")
        for e in (ref, port):
            e.start()
            e.tick()
        yield {"jax": ref, "port": port,
               "dir": tmp_path_factory.mktemp("worlds"), "clock": clock}
        for e in (ref, port):
            e.stop()


def _ask(engines, name, msg):
    """One editor request to each engine: the port's client to the JAX
    engine's server, the JAX package's client to the port's."""
    client = tlivelink if name == "jax" else jlivelink
    return client.editor_request(msg, port=_bound_port(engines[name].server))


_TARGETS = ("Camera", "Engine", "DirectionalLight/0", "Object/1")
# Command -> the requests that exercise it, in order. The ten commands run
# in three groups (the file holds at most seven test cases: pytest-xdist
# queues files with more ahead of tests/test_frame.py).
_COMMANDS = {
    "GetOutliner": [{"Command": "GetOutliner"}],
    "GetDetails": [{"Command": "GetDetails", "Target": t} for t in _TARGETS],
    "SetDetails": [
        {"Command": "SetDetails", "Target": "Camera",
         "Values": {"fov": 60.0}},
        {"Command": "GetDetails", "Target": "Camera"},
        {"Command": "SetDetails", "Target": "Camera",
         "Values": {"fov": 45.0}},
        {"Command": "SetDetails", "Target": "Engine",
         "Values": {"DebugView": 3, "PlayStageRoll": True,
                    "MaterialOverrides": [1.0, 1.0, 1.0, 0.5]}},
        {"Command": "GetDetails", "Target": "Engine"},
        {"Command": "SetDetails", "Target": "Engine",
         "Values": {"DebugView": 0, "PlayStageRoll": False,
                    "MaterialOverrides": [1.0, 1.0, 1.0, 1.0]}},
        {"Command": "SetDetails", "Target": "SpotLight/0",
         "Values": {"intensity": 1.0}},  # no spot light: an error reply
    ],
    "GetStats": [{"Command": "GetStats"}],
    "SaveWorld": [{"Command": "SaveWorld", "Path": "{dir}/{name}.json"}],
    "ReloadWorld": [{"Command": "ReloadWorld",
                     "Path": "{dir}/{name}.json"}],
    "NewWorld": [{"Command": "NewWorld"}, {"Command": "GetOutliner"},
                 {"Command": "ReloadWorld", "Path": "{dir}/{name}.json"},
                 {"Command": "GetOutliner"}],
    "CompileShaders": [{"Command": "CompileShaders"}],
    "RunScript": [{"Command": "RunScript",
                   "Source": "print(len(world.object_descs), "
                             "engine.debug_view, engine.game_mode)"}],
    "Unknown": [{"Command": "Bogus"}],
}


_GROUPS = {
    "queries": ("GetOutliner", "GetDetails", "GetStats", "RunScript",
                "Unknown"),
    "edits": ("SetDetails", "CompileShaders"),
    "file_menu": ("SaveWorld", "ReloadWorld", "NewWorld"),
}


@pytest.mark.parametrize("group", list(_GROUPS))
def test_editor_replies_match_reference(engines, group):
    """Each command's replies from the port's engine equal the JAX
    engine's on the same world. CompileShaders has nothing to recompile
    in the port: the same Status, its own Note."""
    for command in _GROUPS[group]:
        _check_command(engines, command)


def _check_command(engines, command):
    for msg in _COMMANDS[command]:
        replies = {}
        for name in ("jax", "port"):
            m = {k: (v.format(dir=engines["dir"], name=name)
                     if isinstance(v, str) else v) for k, v in msg.items()}
            replies[name] = _ask(engines, name, m)
        want, got = replies["jax"], replies["port"]
        if command == "CompileShaders":
            assert got["Status"] == want["Status"] == "ok"
            assert isinstance(got["Note"], str) and got["Note"]
            continue
        if "Path" in want:
            assert got.pop("Path").endswith("port.json")
            assert want.pop("Path").endswith("jax.json")
        assert got == want, msg
    if command == "SaveWorld":
        saved = {name: json.loads((engines["dir"] / f"{name}.json")
                                  .read_text()) for name in ("jax", "port")}
        assert saved["port"] == saved["jax"]
        assert "MainCamera" in saved["port"]


def test_streamed_worlds_reload_the_port_engine(engines):
    """Worlds pushed by the JAX package's client: a camera-only push
    reloads without a rebuild and moves the frame, an object edit
    rebuilds, bad JSON is logged and the loop goes on."""
    eng = engines["port"]
    port = _bound_port(eng.server)
    before = eng.tick()
    reloads, scene = eng.stats.reloads, eng.scene
    w = small_world(tworld)
    w.main_camera.position = np.float32([1.0, -4.0, 4.0])
    jlivelink.send_data_to_engine(w.to_json(), port=port)
    _wait_pending(eng.server)
    eng.tick()
    moved = eng.tick()  # two frames in flight: the push presents now
    assert eng.stats.reloads == reloads + 1 and eng.scene is scene
    assert not np.array_equal(moved, before)
    w.object_descs[1].instance_count = 6
    tris = eng.meta.num_triangles
    jlivelink.send_data_to_engine(w.to_json(), port=port)
    _wait_pending(eng.server)
    eng.tick()
    assert eng.stats.reloads == reloads + 2 and eng.scene is not scene
    assert eng.meta.num_triangles > tris
    jlivelink.send_data_to_engine("{not json", port=port)
    _wait_pending(eng.server)
    img = eng.tick()
    assert eng.stats.reloads == reloads + 2
    assert img.shape == (TEST_CONFIG.height, TEST_CONFIG.width, 3)
    jlivelink.send_data_to_engine(small_world(tworld).to_json(), port=port)
    _wait_pending(eng.server)
    eng.tick()
    assert eng.stats.reloads == reloads + 3
    assert eng.world.object_descs[1].instance_count == 4


def test_edit_presents_one_tick_later(engines):
    """config.py (frames_in_flight): at two frames in flight under fifo,
    the tick right after an editor edit still presents the frame before
    it; the tick after that presents the edit."""
    eng = engines["port"]
    eng.tick()
    before = eng.tick()
    reply = _ask(engines, "port", {
        "Command": "SetDetails", "Target": "DirectionalLight/0",
        "Values": {"intensity": 0.0}})
    assert reply["Status"] == "ok" and reply["Applied"] == ["intensity"]
    pending = eng.tick()
    after = eng.tick()
    assert float(np.mean(pending)) >= float(np.mean(before)) - 1.0
    assert float(np.mean(after)) < float(np.mean(before)) - 1.0
    _ask(engines, "port", {"Command": "SetDetails",
                           "Target": "DirectionalLight/0",
                           "Values": {"intensity": 5.0}})
    eng.tick()
    assert float(np.mean(eng.tick())) == pytest.approx(
        float(np.mean(before)), abs=1.0)
