"""The port's entry points: importing them loads no JAX, they default to
the card and raise without one, and they run on the CPU when asked."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import zeldaengine_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zeldaengine_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "print('ok')\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_default_to_the_card_and_raise_without_one():
    import torch

    from zeldaengine_tpu_torch import TEST_CONFIG
    from zeldaengine_tpu_torch.convert import scene_from_numpy
    from zeldaengine_tpu_torch.engine import Engine
    from zeldaengine_tpu_torch.passes import build_view_state
    from zeldaengine_tpu_torch.scene import build_demo_scene, make_demo_world
    from zeldaengine_tpu_torch.scene.demo import (
        build_golden_scene, build_textured_demo_scene)

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        build_demo_scene(TEST_CONFIG, grass=2, rocks=1)
    for build in (build_textured_demo_scene, build_golden_scene):
        with pytest.raises(RuntimeError, match="cuda"):
            build(TEST_CONFIG)
    with pytest.raises(RuntimeError, match="cuda"):
        build_view_state(make_demo_world(), TEST_CONFIG)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(TEST_CONFIG)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine()  # the JAX package's defaults: mailbox, livelink on 8080
    with pytest.raises(RuntimeError, match="cuda"):
        scene_from_numpy({})


def test_engine_cli_without_a_card_fails_and_chip_smoke_fails():
    """The engine's and the viewer's CLIs and chip_smoke.py fail without a
    card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run("from zeldaengine_tpu_torch.engine import main; "
               "main(['--frames', '1', '--width', '128', '--height', '128'])")
    assert res.returncode != 0 and "cuda" in res.stderr
    viewer = subprocess.run(
        [sys.executable, "-m", "zeldaengine_tpu_torch.viewer", "--port", "0",
         "--livelink-port", "0", "--width", "64", "--height", "64"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert viewer.returncode != 0 and "cuda" in viewer.stderr
    smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    assert smoke.returncode != 0
    assert '"ok": true' not in smoke.stdout


def test_engine_renders_on_the_cpu_when_asked(tmp_path):
    from zeldaengine_tpu_torch import TEST_CONFIG
    from zeldaengine_tpu_torch.engine import Engine, main
    from zeldaengine_tpu_torch.scene import demo_world
    from zeldaengine_tpu_torch.utils.image import read_png

    cfg = TEST_CONFIG.replace(frames_in_flight=1, present_mode="fifo",
                              point_light_kernel="unroll")
    eng = Engine(cfg, world=demo_world(grass=20, rocks=2), device="cpu")
    img = eng.tick()
    assert img.shape == (128, 128, 3) and img.dtype.name == "uint8"
    assert eng.stats.frame_index == 1 and eng.stats.frame_ms > 0
    assert img.std() > 1
    # The CLI at its defaults (mailbox, two frames in flight, livelink
    # started on a free port) on a saved world, three frames to a PNG.
    world, out = str(tmp_path / "World.json"), str(tmp_path / "f.png")
    demo_world(grass=20, rocks=2).save(world)
    main(["--frames", "3", "--width", "128", "--height", "128", "--device",
          "cpu", "--port", "0", "--world", world, "--out", out])
    assert read_png(out).shape[:2] == (128, 128)


def test_bad_raster_value_and_cuda_on_cpu_raise():
    from zeldaengine_tpu_torch import TEST_CONFIG
    from zeldaengine_tpu_torch.passes import build_view_state, render_frame
    from zeldaengine_tpu_torch.scene import build_demo_scene

    cfg = TEST_CONFIG.replace(point_light_kernel="unroll")
    scene, meta, world = build_demo_scene(cfg, grass=10, rocks=2,
                                          device="cpu")
    view = build_view_state(world, cfg, device="cpu")
    with pytest.raises(ValueError, match="raster"):
        render_frame(scene, view, meta, cfg.replace(raster="pallas"))
    with pytest.raises(RuntimeError, match="card"):
        render_frame(scene, view, meta, cfg.replace(raster="cuda"))
