"""The port stands alone: its sources import neither JAX nor the JAX
package. (What its entry points do without a card is in
test_torch_entry_points.py; the scan of the remaining source directories
is in test_torch_no_jax_more.py.)

Every tests/test_torch_*.py file holds at most seven tests: pytest-xdist
hands out files in order of their number of tests, and the port's files
must queue behind the JAX package's long-running ones, not ahead of them."""

import os

import pytest

from _torch_sources import (
    FIRST_GROUPS, PKG, ROOT, assert_imports_no_jax, groups, py_files)


def test_package_layout_is_there():
    files = {os.path.relpath(f, ROOT) for f in py_files()}
    for want in ("chip_smoke.py", "zeldaengine_tpu_torch/convert.py",
                 "zeldaengine_tpu_torch/engine.py",
                 "zeldaengine_tpu_torch/ops/rasterize_cuda.py",
                 "zeldaengine_tpu_torch/ops/pcf_cuda.py",
                 "zeldaengine_tpu_torch/ops/window_tap.py",
                 "zeldaengine_tpu_torch/ops/lighting_cuda.py",
                 "zeldaengine_tpu_torch/ops/pcf_window.py",
                 "zeldaengine_tpu_torch/ops/pcf_tables.py",
                 "zeldaengine_tpu_torch/passes/frame.py",
                 "zeldaengine_tpu_torch/native/__init__.py",
                 "zeldaengine_tpu_torch/meshlet/build.py",
                 "zeldaengine_tpu_torch/meshlet/io.py",
                 "zeldaengine_tpu_torch/ops/culling.py",
                 "zeldaengine_tpu_torch/tools/meshletgen.py",
                 "zeldaengine_tpu_torch/tools/gather_probe.py",
                 "zeldaengine_tpu_torch/tools/walk_stats.py",
                 "zeldaengine_tpu_torch/livelink/server.py",
                 "zeldaengine_tpu_torch/livelink/client.py",
                 "zeldaengine_tpu_torch/livelink/editor.py",
                 "zeldaengine_tpu_torch/viewer.py",
                 "zeldaengine_tpu_torch/profiling.py",
                 "zeldaengine_tpu_torch/ops/envtap.py",
                 "zeldaengine_tpu_torch/scene/fbx.py",
                 "zeldaengine_tpu_torch/parallel/__init__.py",
                 "zeldaengine_tpu_torch/parallel/tiles.py"):
        assert want in files
    assert os.path.exists(os.path.join(PKG, "native", "zeldanative.cpp"))
    # The scan covers the sub-packages as their own cases.
    assert {"native", "meshlet", "tools", "livelink", "parallel"} <= set(
        groups())
    csrc = set(os.listdir(os.path.join(PKG, "csrc")))
    assert {"pair_raster.cu", "pair_raster_fused.cu", "pcf_taps.cu",
            "bilinear_tap.cu", "point_lights.cu", "pcf_window.cu",
            "pcf_window_table.cu", "fma.cu", "triangle_setup.cu",
            "gather_probe.cu", "fma_peak.cu"} <= csrc
    # Every kernel registered with its wrapper has a C entry point bound.
    from zeldaengine_tpu_torch.ops import KERNEL_WRAPPERS, _build

    assert len(KERNEL_WRAPPERS) == 12
    for name in KERNEL_WRAPPERS:
        assert "zk_" + name in _build._SIGNATURES


@pytest.mark.parametrize("group", sorted(groups())[:FIRST_GROUPS])
def test_source_imports_no_jax(group):
    assert_imports_no_jax(group)
