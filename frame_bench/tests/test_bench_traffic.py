"""The traffic generator is deterministic from --seed, and the seed sets
only the starting phase and the sampled frames, never the steps."""

import numpy as np
import pytest

from frame_bench.harness import spec
from frame_bench.harness.traffic import Traffic
from frame_bench.reference.render import orbit_positions, world_from_doc

SEEDS = [0, 7, 2**31 + 123, 2**40 + 5]


@pytest.mark.parametrize("name", ["orbit", "stream"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_traffic(name, seed):
    params = spec.load_traffic(name)
    a, b = Traffic(params, seed), Traffic(params, seed)
    assert a.frame_yaws() == b.frame_yaws()
    assert a.sample_points(5) == b.sample_points(5)
    doc = spec.load_config("demo1080")["world"]
    np.testing.assert_array_equal(
        a.push_cameras(world_from_doc(doc).main_camera, 20),
        b.push_cameras(world_from_doc(doc).main_camera, 20))
    lo, hi = params["camera"]["start_yaw_deg"]
    assert lo <= a.start_yaw < hi
    assert a.yaw_step == params["camera"]["yaw_step_deg"]
    assert all(0.0 < p < 1.0 for p in a.sample_points(5))


def test_seeds_change_the_phase_not_the_steps():
    params = spec.load_traffic("stream")
    t = [Traffic(params, s) for s in SEEDS]
    assert len({x.start_yaw for x in t}) == len(SEEDS)
    assert {(x.yaw_step, x.push_interval, x.push_yaw_step) for x in t} == {
        (0.0, 0.05, 1.0)}


def test_negative_seed_is_refused():
    with pytest.raises(ValueError):
        Traffic(spec.load_traffic("orbit"), -1)


def test_orbit_keeps_the_arm_and_height():
    doc = spec.load_config("meshlet1m")["world"]
    cam = world_from_doc(doc).main_camera
    pos = orbit_positions(doc, 33.0, 1.0, 400)
    arm = np.linalg.norm(pos - cam.lookat, axis=1)
    np.testing.assert_allclose(arm, cam.arm_length, rtol=1e-5)
    np.testing.assert_allclose(pos[:, 2], cam.position[2], atol=1e-4)
    assert len({tuple(p) for p in pos}) == 400
