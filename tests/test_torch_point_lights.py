"""Point lights culled to screen tiles: the port's cull, tiled loop and the
plain version of kernel point_lights against the JAX package's
cull_point_lights_tiled, _point_lighting_tiled and point-light Pallas
kernel (interpret mode) on the same NumPy inputs. The CUDA kernel itself
is held against its plain version on the card by chip_smoke.py."""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zeldaengine_tpu.math.transforms import look_at, perspective
from zeldaengine_tpu.ops import lighting as jl
from zeldaengine_tpu.ops.lighting_pallas import point_lighting_pallas
from zeldaengine_tpu_torch.ops import lighting as tl
from zeldaengine_tpu_torch.ops import lighting_cuda

torch.set_num_threads(1)


def _unit(a):
    return (a / np.sqrt(np.maximum((a * a).sum(-1, keepdims=True), 1e-20))
            ).astype(np.float32)


def _scene(h=48, w=256, n_lights=5, seed=0, slots=8):
    """tests/test_lighting_pallas.py::_scene in NumPy: a tilted ground
    plane seen by a perspective camera, ``n_lights`` live point lights in
    a table of ``slots``."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    p = np.stack([xs / w * 20 - 10, ys / h * 20 - 10,
                  0.1 * np.sin(xs / 9.0)], -1).astype(np.float32)
    n = _unit(np.tile(np.asarray([0.1, 0.0, 1.0], np.float32), (h, w, 1)))
    cam = np.asarray([0.0, -6.0, 8.0], np.float32)
    v = _unit(cam - p)
    ndotv = np.clip(np.sum(n * v, -1), 0.0, 1.0).astype(np.float32)
    dc = rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, (h, w)).astype(np.float32)
    lights = np.zeros((slots, 4, 4), np.float32)
    for i in range(n_lights):
        lights[i, 0, :3] = [rng.uniform(-9, 9), rng.uniform(-9, 9),
                            rng.uniform(0.5, 2.0)]
        lights[i, 1, :3] = rng.uniform(0.2, 1.0, 3)
        lights[i, 1, 3] = rng.uniform(1.0, 8.0)
        lights[i, 2, 3] = rng.uniform(1.0, 6.0)
    view_proj = np.array(
        perspective(45.0, w / h, 0.1, 100.0)
        @ look_at(cam, np.zeros(3, np.float32),
                  np.asarray([0, 0, 1], np.float32)), np.float32)
    return dict(dc=dc, rough=rough, n=n, p=p, v=v, ndotv=ndotv,
                lights=lights, n_live=n_lights, view_proj=view_proj)


def _views(s):
    jv = types.SimpleNamespace(view_proj=jnp.asarray(s["view_proj"]),
                               camera_fov=np.float32(45.0))
    tv = types.SimpleNamespace(view_proj=torch.from_numpy(s["view_proj"]),
                               camera_fov=torch.tensor(45.0))
    return jv, tv


def _cull_both(s, tile_h, tile_w, k_max, covered=None):
    h, w = s["rough"].shape
    cov = np.ones((h, w), bool) if covered is None else covered
    jv, tv = _views(s)
    want = jl.cull_point_lights_tiled(
        jnp.asarray(s["lights"]), jnp.int32(s["n_live"]), jv, w, h, tile_h,
        tile_w, k_max, world_pos=jnp.asarray(s["p"]),
        covered=jnp.asarray(cov))
    got = tl.cull_point_lights_tiled(
        torch.from_numpy(s["lights"]), s["n_live"], tv, w, h, tile_h,
        tile_w, k_max, world_pos=torch.from_numpy(s["p"]),
        covered=torch.from_numpy(cov))
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _assert_lists_equal(want, got):
    (j_idx, j_cnt, j_drops), (t_idx, t_cnt, t_drops) = want, got
    np.testing.assert_array_equal(t_cnt, j_cnt)
    assert int(t_drops) == int(j_drops)
    live = np.arange(j_idx.shape[-1]) < j_cnt[..., None]
    np.testing.assert_array_equal(t_idx[live], j_idx[live])
    np.testing.assert_array_equal(t_idx, j_idx)  # the tails too
    return int(j_drops)


@pytest.mark.parametrize("block_h", [8, 40])
def test_kernel_plain_matches_point_lighting_pallas(block_h):
    s = _scene()
    h, w = s["rough"].shape
    cull_want, cull_got = _cull_both(s, block_h, 128, 8)
    assert _assert_lists_equal(cull_want, cull_got) == 0
    acc = np.random.default_rng(3).uniform(0, 0.2, (h, w, 3)).astype(
        np.float32)
    keys = ("dc", "rough", "n", "p", "v", "ndotv")
    want = point_lighting_pallas(
        jnp.asarray(acc), *(jnp.asarray(s[k]) for k in keys),
        jnp.asarray(s["lights"]), *(jnp.asarray(a) for a in cull_want[:2]),
        block_h=block_h, interpret=True)
    got = lighting_cuda.point_lighting(
        torch.from_numpy(acc), *(torch.from_numpy(s[k]) for k in keys),
        torch.from_numpy(s["lights"]),
        *(torch.from_numpy(a) for a in cull_got[:2]), block_h=block_h)
    # tests/test_lighting_pallas.py's tolerance (XLA contracts
    # multiply-adds in interpret mode; the port does not).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    assert float(got.max()) > 0.3  # the lights reach the plane
    assert lighting_cuda.point_lighting.launches == 0
    # The constant of fr_disney_diffuse: 1/1.51 in double, rounded once.
    assert np.float32(lighting_cuda.E_SCALE) == np.float32(1.0 / 1.51)


@pytest.mark.parametrize("case", ["partly_covered", "cap_of_32"])
def test_cull_matches_jax(case):
    if case == "partly_covered":
        s = _scene(h=96, w=384, n_lights=7, seed=1, slots=16)
        cov = np.random.default_rng(4).random((96, 384)) < 0.7
        cov[:40, :128] = False  # tiles with nothing to shade keep no light
        want, got = _cull_both(s, 40, 128, 32, covered=cov)
        assert _assert_lists_equal(want, got) == 0
        assert got[1][0, 0] == 0 and got[1].max() > 0
    else:
        # 128 live lights with a wide reach: tiles see more than 32 hits,
        # and the stable order decides which 32 are kept.
        s = _scene(h=48, w=256, n_lights=128, seed=2, slots=128)
        s["lights"][:, 2, 3] = 9.0
        want, got = _cull_both(s, 8, 128, 32)
        assert _assert_lists_equal(want, got) > 0
        assert got[1].max() == 32


def test_tiled_loop_matches_jax():
    s = _scene(h=44, w=256, n_lights=6, seed=5, slots=8)
    want_c, got_c = _cull_both(s, 8, 128, 32)
    _assert_lists_equal(want_c, got_c)
    keys = ("dc", "rough", "n", "p", "v", "ndotv")
    want = jl._point_lighting_tiled(
        *(jnp.asarray(s[k]) for k in keys), jnp.asarray(s["lights"]),
        *(jnp.asarray(a) for a in want_c[:2]), 8, 128)
    got = tl._point_lighting_tiled(
        *(torch.from_numpy(s[k]) for k in keys),
        torch.from_numpy(s["lights"]),
        *(torch.from_numpy(a) for a in got_c[:2]), 8, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    assert float(got.max()) > 0.1


def test_kernel_plain_equals_tiled_and_unrolled_paths_of_the_port():
    """direct_lighting's three point-light paths in the port on one input:
    the kernel's plain version, the tiled loop and the unrolled loop."""
    s = _scene(h=40, w=128, n_lights=5, seed=6, slots=8)
    h, w = s["rough"].shape
    t = {k: torch.from_numpy(s[k]) for k in ("dc", "rough", "n", "p", "v",
                                             "ndotv")}
    lights = torch.from_numpy(s["lights"])
    args = (t["dc"], t["rough"], t["n"], t["p"], t["v"], t["ndotv"],
            torch.ones((h, w)), torch.zeros((1, 4, 4)), 0, lights,
            s["n_live"])
    _, tv = _views(s)
    idx, cnt, _ = tl.cull_point_lights_tiled(
        lights, s["n_live"], tv, w, h, 8, 128, 32, world_pos=t["p"])
    unrolled = tl.direct_lighting(*args)
    kernel = tl.direct_lighting(*args, pallas_points=(idx, cnt, 8, "auto"))
    tiled = tl.direct_lighting(*args, tiled_points=(idx, cnt, 8, 128))
    np.testing.assert_allclose(kernel.numpy(), unrolled.numpy(), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(tiled.numpy(), unrolled.numpy(), rtol=5e-5,
                               atol=5e-5)


def test_wrapper_checks_its_inputs():
    s = _scene(h=16, w=128, n_lights=2)
    args = [torch.from_numpy(s[k]) for k in ("dc", "rough", "n", "p", "v",
                                             "ndotv")]
    acc = torch.zeros((16, 128, 3))
    lights = torch.from_numpy(s["lights"])
    idx = torch.zeros((2, 1, 8), dtype=torch.int32)
    cnt = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="card"):
        lighting_cuda.point_lighting(acc, *args, lights, idx, cnt,
                                     block_h=8, backend="cuda")
    with pytest.raises(ValueError, match="blocks"):
        lighting_cuda.point_lighting(acc, *args, lights, idx, cnt,
                                     block_h=16)
    out = lighting_cuda.point_lighting(acc, *args, lights, idx, cnt,
                                       block_h=8)
    assert torch.equal(out, acc)  # no live slot: the sum is untouched
    assert lighting_cuda.point_lighting.launches == 0
