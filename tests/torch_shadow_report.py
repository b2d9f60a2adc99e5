"""Where the port's frame and the JAX package's frame part at the default
``shadow_bias=0``, in numbers (CPU, TEST_CONFIG with unrolled point lights,
``build_demo_scene(grass=50, rocks=4)``, the scene and view carried across):

    JAX_PLATFORMS=cpu python tests/torch_shadow_report.py

Prints, as fractions of image values off by more than 4/255 (the golden
criterion allows 0.01): port vs the jitted reference, port vs the
reference run op by op (``jax.disable_jit()``: no fused multiply-adds),
the reference op by op vs itself jitted; how far the shadow maps are
apart; and the jitted reference's frame against itself when its shadow map
is moved by the port-minus-reference difference restricted to one size
band, which shows which texels carry the image difference.
tests/test_torch_frame.py asserts the first three; this script is not
collected by pytest.
"""

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from zeldaengine_tpu.config import TEST_CONFIG as JCFG  # noqa: E402
from zeldaengine_tpu.passes import (  # noqa: E402
    build_view_state as j_view, render_frame as j_render)
from zeldaengine_tpu.passes.frame import render_rows as j_rows  # noqa: E402
from zeldaengine_tpu.scene.demo import build_demo_scene as j_build  # noqa: E402
from zeldaengine_tpu_torch import TEST_CONFIG  # noqa: E402
from zeldaengine_tpu_torch.convert import (  # noqa: E402
    scene_from_numpy, view_from_numpy)
from zeldaengine_tpu_torch.passes import render_frame  # noqa: E402
from zeldaengine_tpu_torch.scene.scenebuild import SceneMeta  # noqa: E402

from _torch_compare import to_numpy_leaves  # noqa: E402


def off(a, b) -> float:
    return float((np.abs(np.asarray(a) - np.asarray(b)) > 4 / 255).mean())


def main() -> None:
    torch.set_num_threads(1)
    kw = dict(point_light_kernel="unroll")
    jcfg, cfg = JCFG.replace(**kw), TEST_CONFIG.replace(**kw)
    jscene, jmeta, jworld = j_build(jcfg, grass=50, rocks=4)
    jview = j_view(jworld, jcfg, time=0.1, roll_light=0.02)
    jimg, jaux = j_render(jscene, jview, jmeta, jcfg)
    with jax.disable_jit():
        nimg, naux = j_render(jscene, jview, jmeta, jcfg)
    scene = scene_from_numpy(to_numpy_leaves(jscene), "cpu")
    view = view_from_numpy(to_numpy_leaves(jview), "cpu")
    meta = SceneMeta(**dataclasses.asdict(jmeta))
    img, aux = render_frame(scene, view, meta, cfg)
    img = img.numpy()
    jsm = np.array(jaux["shadowmap"])
    delta = aux["shadowmap"].numpy() - jsm
    out = {
        "off_port_vs_jitted": off(img, jimg),
        "off_port_vs_op_by_op": off(img, nimg),
        "off_op_by_op_vs_jitted": off(nimg, jimg),
        "shadowmap_max_abs_port_vs_op_by_op": float(np.abs(
            aux["shadowmap"].numpy() - np.asarray(naux["shadowmap"])).max()),
        "shadowmap_abs_port_vs_jitted_quantiles_50_90_99_999_max": [
            float(q) for q in np.quantile(np.abs(delta),
                                          [0.5, 0.9, 0.99, 0.999, 1.0])],
    }

    def jitted_with(shadowmap):
        im, _ = j_rows(jscene, jview, jmeta, jcfg,
                       shadowmap_override=jnp.asarray(shadowmap))
        return np.asarray(im)

    base = jitted_with(jsm)
    out["off_jitted_on_port_shadowmap_vs_itself"] = off(
        jitted_with(jsm + delta), base)
    edges = [0.0, 1e-6, 1e-5, 1e-4, 1e-3, 10.0]
    bands = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (np.abs(delta) > lo) & (np.abs(delta) <= hi)
        bands.append({"band": [lo, hi], "texels": float(m.mean()),
                      "off_jitted_vs_itself": off(
                          jitted_with(jsm + np.where(m, delta, 0)), base)})
    out["shadowmap_difference_by_band"] = bands
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
