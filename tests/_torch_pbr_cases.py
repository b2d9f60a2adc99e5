"""The pbr term cases shared by tests/test_torch_pbr_*.py, and small helpers
of the shading tests: each case runs one function of ``ops/pbr.py`` of both
packages on the same seeded inputs."""

import numpy as np
import jax.numpy as jnp
import torch

from zeldaengine_tpu.ops import pbr as jpbr
from zeldaengine_tpu_torch.ops import pbr as tpbr

HW = (24, 40)


def unit(rng, shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


PBR_CASES = {
    "pow5": lambda m, a: m.pow5(a["x"]),
    "f_schlick": lambda m, a: m.f_schlick(a["x3"], a["y"][..., None],
                                          a["x"][..., None]),
    "fr_disney_diffuse": lambda m, a: m.fr_disney_diffuse(
        a["x"], a["y"], a["z"], a["r"]),
    "v_smith_ggx_correlated": lambda m, a: m.v_smith_ggx_correlated(
        a["x"], a["y"], a["r"]),
    "d_ggx": lambda m, a: m.d_ggx(a["x"], a["r"]),
    "reflection_mip": lambda m, a: m.reflection_mip_from_roughness(
        a["r"], 6.0),
    "env_brdf_approx": lambda m, a: m.env_brdf_approx(a["x3"], a["r"],
                                                      a["x"]),
    "specular_occlusion": lambda m, a: m.specular_occlusion(
        a["x"], a["r"] * a["r"], a["y"]),
    "compute_f0": lambda m, a: m.compute_f0(0.5, a["x3"], a["y"]),
    "default_lit_bxdf_d": lambda m, a: m.default_lit_bxdf(
        a["x3"], a["r"], a["x"], a["y"], a["z"], a["x"])[0],
    "default_lit_bxdf_s": lambda m, a: m.default_lit_bxdf(
        a["x3"], a["r"], a["x"], a["y"], a["z"], a["x"])[1],
    "refract": lambda m, a: m.refract(a["n3"], a["m3"], 1.0 / 1.52),
    "normalize": lambda m, a: m.normalize(a["x3"]),
    "tangent_normal": lambda m, a: m.compute_tangent_normal(
        a["p3"], a["q3"], a["x3"][..., :2], a["n3"][..., :2], a["m3"],
        a["x3"]),
}


def check_pbr_case(name):
    rng = np.random.default_rng(3)
    arrs = {k: rng.random(HW).astype(np.float32) for k in "xyz"}
    arrs["r"] = (0.05 + 0.95 * rng.random(HW)).astype(np.float32)
    arrs["x3"] = rng.random(HW + (3,)).astype(np.float32)
    arrs["n3"], arrs["m3"] = unit(rng, HW), unit(rng, HW)
    arrs["p3"] = rng.normal(size=HW + (3,)).astype(np.float32)
    arrs["q3"] = rng.normal(size=HW + (3,)).astype(np.float32)
    fn = PBR_CASES[name]
    want = fn(jpbr, {k: J(v) for k, v in arrs.items()})
    got = fn(tpbr, {k: T(v) for k, v in arrs.items()})
    # d_ggx and the BxDF reach O(100) at low roughness: relative 2e-5.
    close(got, want, atol=1e-5, rtol=2e-5)
