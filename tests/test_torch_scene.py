"""config, scene/ and passes/view of the port against the JAX package: the
same fields and defaults, the same scene pools leaf by leaf, the same view
state."""

import dataclasses

import numpy as np
import pytest
import torch

from zeldaengine_tpu.config import TEST_CONFIG as JCFG, EngineConfig as JConfig
from zeldaengine_tpu.passes.view import build_view_state as j_view
from zeldaengine_tpu.scene.demo import build_demo_scene as j_build
from zeldaengine_tpu_torch import TEST_CONFIG, EngineConfig
from zeldaengine_tpu_torch.passes.view import (
    HOST_LEAVES, build_view_state)
from zeldaengine_tpu_torch.scene import build_demo_scene
from zeldaengine_tpu_torch.scene.mesh import load_obj, make_cube, save_obj

from _torch_compare import to_numpy_leaves

torch.set_num_threads(1)


def test_config_keeps_every_field_and_default():
    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    got = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert got == want
    assert dataclasses.asdict(TEST_CONFIG) == dataclasses.asdict(JCFG)
    cfg = EngineConfig(width=1920, height=1080, tile_h=64, tile_w=32)
    assert (cfg.padded_height, cfg.n_tiles_x, cfg.cubemap_mips) == (
        1088, 60, 9)


@pytest.fixture(scope="module")
def demo():
    j = j_build(JCFG, grass=50, rocks=4)
    t = build_demo_scene(TEST_CONFIG, grass=50, rocks=4, device="cpu")
    return j, t


def test_demo_scene_pools_equal_leaf_by_leaf(demo):
    (jscene, jmeta, _), (tscene, tmeta, _) = demo
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    for name, want in to_numpy_leaves(jscene).items():
        got = getattr(tscene, name)
        if want is None:
            assert got is None, name
            continue
        assert got.device.type == "cpu"
        bf16 = np.asarray(getattr(jscene, name)).dtype.name == "bfloat16"
        assert (got.dtype == torch.bfloat16) == bf16, name
        got = got.float().numpy() if bf16 else got.numpy()
        assert got.shape == want.shape, name
        if want.dtype.kind in "iub" or bf16:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got.dtype == want.dtype, name
            # 1e-6: the pools are built by the same NumPy code.
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(time=0.25, roll_light=0.1),
    dict(roll_stage=0.4, animate_point_lights=False, overrides=(1, 2, 3, 4)),
    dict(light_capacities=(2, 32, 2), right_bar=10.0, bottom_bar=5.0),
])
def test_view_state_matches_jax(demo, kw):
    (_, _, jworld), (_, _, tworld) = demo
    want = to_numpy_leaves(j_view(jworld, JCFG, **kw))
    got = build_view_state(tworld, TEST_CONFIG, device="cpu", **kw)
    for name, w in want.items():
        g = getattr(got, name)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    for name in HOST_LEAVES:
        assert getattr(got, name).device.type == "cpu"


def test_view_state_leaves_do_not_alias_the_world(demo):
    _, (_, _, world) = demo
    view = build_view_state(world, TEST_CONFIG, device="cpu")
    before = view.camera_pos.clone()
    world.main_camera.position += 1.0
    try:
        assert torch.equal(view.camera_pos, before)
    finally:
        world.main_camera.position -= 1.0


def test_obj_round_trip_and_fbx_refused(tmp_path):
    from zeldaengine_tpu.scene.mesh import load_obj as j_load_obj
    from zeldaengine_tpu_torch.scene.mesh import load_mesh

    path = str(tmp_path / "cube.obj")
    save_obj(make_cube(1.0), path)
    got, want = load_obj(path), j_load_obj(path)
    for name in ("positions", "normals", "uvs", "indices", "colors"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_mesh("thing.fbx")
