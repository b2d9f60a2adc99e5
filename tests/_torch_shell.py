"""Helpers shared by the tests of the port's engine shell: one small world
built with either package's World classes, a settable clock that stands
in for the ``time`` module of both engines, and the uint8 frame criterion
between the two packages' engines."""

import numpy as np


def small_world(world_mod):
    """tests/test_editor.py::_small_world, built from ``world_mod`` (the
    ``scene.world`` module of either package)."""
    w = world_mod.World()
    w.main_camera = world_mod.CameraDesc(
        position=np.array([0.0, -4.0, 4.0], np.float32),
        lookat=np.array([0.0, 0.0, 0.0], np.float32),
    )
    sun = np.array([5.0, -5.0, 10.0], np.float32)
    w.directional_lights = [
        world_mod.LightDesc(position=sun, type=0, intensity=5.0,
                            direction=sun / np.linalg.norm(sun))
    ]
    w.object_descs = [
        world_mod.ObjectDesc(
            profab_name="terrain",
            render_flags=int(world_mod.RenderFlags.NONE), instance_count=1),
        world_mod.ObjectDesc(
            profab_name="rock_02",
            render_flags=int(world_mod.RenderFlags.DEFERRED_SCENE),
            instance_count=4, min_radius=0.5, max_radius=2.0,
            min_pscale=0.3, max_pscale=0.6),
    ]
    return w


class FakeClock:
    """Stands in for the ``time`` module an engine reads: ``time()``
    returns ``now``, which only the test moves."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def time(self) -> float:
        return self.now


def u8_frame_diff(got, want) -> tuple:
    """(largest difference, share of values off by more than 1) of two
    uint8 frames of one shape."""
    assert got.dtype == np.uint8 and want.dtype == np.uint8
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(diff.max()), float((diff > 1).mean())
