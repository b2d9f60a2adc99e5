"""The committed goldens (tests/golden/*.png, rendered by the JAX package
on the CPU, jitted) met by the port: tests/test_golden.py's scene, built
by the port's own SceneBuilder (``scene/demo.py::build_golden_scene``)
and rendered through the port's plain versions in debug views 0, 1, 4, 8
and 9, by tests/test_golden.py's criterion. The scene has a
checker-textured deferred cube (the mip-pair atlas fetch), a forward
sphere z-tested against the GBuffer depth, the quad cube atlas in view 9
and the raw shadow factor in view 8.

The scene, its setup and its frames against the JAX package's are in
test_torch_golden_reference.py."""

import os

import pytest
import torch

from zeldaengine_tpu_torch.utils.image import read_png

from _torch_compare import assert_golden
from test_golden import GOLDEN_DIR, VIEWS

from _torch_golden_scene import port_frames

torch.set_num_threads(1)

port = pytest.fixture(scope="module")(port_frames)


@pytest.mark.parametrize("name", sorted(VIEWS))
def test_port_meets_the_goldens(port, name):
    """tests/test_golden.py:97-102 on the port's frame: fewer than 1 % of
    values off by more than 4/255, median at most 1/255 (measured: 0.0 of
    values off in every view)."""
    img = port[4][name][0]
    assert tuple(img.shape) == (128, 128, 3) and bool(
        torch.isfinite(img).all())
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))[..., :3]
    assert_golden(img.numpy(), golden, name)
    assert float(img.std()) > 0.01
