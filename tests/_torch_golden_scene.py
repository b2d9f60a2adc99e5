"""tests/test_golden.py's scene built and rendered by the port, shared by
tests/test_torch_golden*.py."""

import functools

import torch

from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.passes import render_frame
from zeldaengine_tpu_torch.scene.demo import build_golden_scene

from test_golden import VIEWS


def _build(right_bar=0.0, bottom_bar=0.0):
    """tests/test_golden.py::_build with the port's modules."""
    scene, meta, view = build_golden_scene(
        TEST_CONFIG, right_bar=right_bar, bottom_bar=bottom_bar,
        device="cpu")
    return TEST_CONFIG, scene, meta, view


def _view(view, dv):
    return view._replace(debug_view=torch.tensor(dv, dtype=torch.int32))


@functools.lru_cache(maxsize=1)
def port_frames():
    """The port's golden scene and its frame in every view of
    tests/test_golden.py. Built once a process: both files' module
    fixtures share it (read only)."""
    cfg, scene, meta, view = _build()
    out = {name: render_frame(scene, _view(view, dv), meta, cfg)
           for name, dv in VIEWS.items()}
    return cfg, scene, meta, view, out
