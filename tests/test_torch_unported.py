"""Every ``EngineConfig`` value of the JAX package renders in the port, and
nothing is silently served by another path: a backend name neither package
knows raises ``ValueError`` before any work, for each backend field."""

import pytest
import torch

from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.passes import build_view_state, render_frame
from zeldaengine_tpu_torch.passes.frame import render_rows
from zeldaengine_tpu_torch.scene import build_demo_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frame_args():
    cfg = TEST_CONFIG
    scene, meta, world = build_demo_scene(cfg, grass=10, rocks=2,
                                          device="cpu")
    view = build_view_state(world, cfg, device="cpu")
    return scene, view, meta, cfg


@pytest.mark.parametrize("field", ["pcf_backend", "raster"])
def test_unknown_backend_raises(frame_args, field):
    scene, view, meta, cfg = frame_args
    bad = cfg.replace(**{field: "no_such_backend"})
    with pytest.raises(ValueError, match=field):
        render_rows(scene, view, meta, bad)
    with pytest.raises(ValueError, match=field):
        render_rows(scene, view, meta, bad, y0=cfg.tile_h,
                    rows=cfg.tile_h, full_frame=False)
    # ... and the frame these were derived from renders.
    img, _ = render_frame(scene, view, meta, cfg)
    assert bool(torch.isfinite(img).all())
