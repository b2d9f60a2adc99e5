"""Everything outside the ported slice raises ``NotImplementedError``
naming the ``ROADMAP.md`` item that will bring it; nothing is silently
served by another path. One test per part of the frame, each going through
all of that part's unported values."""

import dataclasses

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


# part of the frame -> [(what to change, the ROADMAP item it must name)].
# A dict changes the config; a string names a change of view, scene, meta
# or band (see _apply).
_UNPORTED = {
    "raster_options": [
        (dict(compact_tris=512), "compact_setup"),
        (dict(compact_tris_shadow=512), "compact_setup"),
        (dict(pair_align=True), "align"),
        (dict(raster_early_out=True), "early-out"),
    ],
    # The PCF variants without a kernel (the others are ported).
    "pcf_backends": [
        (dict(pcf_backend="packed_y4"), "A9"),
        (dict(pcf_backend="packed_y8"), "A9"),
        (dict(pcf_backend="packed4"), "A9"),
        (dict(pcf_backend="packed16"), "A9"),
        (dict(pcf_backend="window1"), "A9"),
        (dict(pcf_backend="half_y4"), "A9"),
    ],
    "passes": [
        (dict(env_merge=True), "envtap"),
        (dict(wireframe=True), "wireframe"),
        (dict(skydome_mode="mesh"), "skydome_mesh"),
        (dict(enable_background=True), "background"),
        (dict(validation=True), "validation"),
    ],
    "shading": [
        (dict(reflection_half=True), "half"),
        (dict(ablate="nopcf"), "ablations"),
    ],
    "scene_facts": [
        ("has_meshlets", "culling"),
    ],
    "view_and_bands": [
        ("band", "parallel/tiles.py"),
    ],
}


def _apply(change, scene, view, meta, cfg):
    """(scene, view, meta, cfg, render_rows keywords) with one change."""
    kw = {}
    if isinstance(change, dict):
        cfg = cfg.replace(**change)
    elif change == "band":
        kw = dict(y0=0, rows=64, full_frame=False)
    else:
        meta = dataclasses.replace(meta, **{change: True})
    return scene, view, meta, cfg, kw


@pytest.mark.parametrize("part", sorted(_UNPORTED))
def test_unported_raises(frame_args, part):
    for change, item in _UNPORTED[part]:
        scene, view, meta, cfg, kw = _apply(change, *frame_args)
        with pytest.raises(NotImplementedError) as err:
            render_rows(scene, view, meta, cfg, **kw)
        msg = str(err.value)
        assert "ROADMAP.md" in msg and item in msg, (change, msg)
    # ... and the frame these were derived from renders.
    scene, view, meta, cfg = frame_args
    img, _ = render_frame(scene, view, meta, cfg)
    assert bool(torch.isfinite(img).all())
