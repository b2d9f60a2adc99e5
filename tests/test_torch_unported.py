"""Everything outside the ported slice raises ``NotImplementedError``
naming the ``ROADMAP.md`` item that will bring it; nothing is silently
served by another path. One test per part of the frame, each going through
all of that part's unported values."""

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
# A dict changes the config; "band" asks for a row band (see _apply).
_UNPORTED = {
    # The PCF variants without a kernel (the others are ported).
    "pcf_backends": [
        (dict(pcf_backend="packed_y4"), "A9"),
        (dict(pcf_backend="packed_y8"), "A9"),
        (dict(pcf_backend="packed4"), "A9"),
        (dict(pcf_backend="packed16"), "A9"),
        (dict(pcf_backend="window1"), "A9"),
        (dict(pcf_backend="half_y4"), "A9"),
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
    else:
        assert change == "band", change
        kw = dict(y0=0, rows=64, full_frame=False)
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
