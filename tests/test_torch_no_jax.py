"""The port stands alone: its sources import neither JAX nor the JAX
package. (What its entry points do without a card is in
test_torch_entry_points.py.)

Every tests/test_torch_*.py file holds at most seven tests: pytest-xdist
hands out files in order of their number of tests, and the port's files
must queue behind the JAX package's long-running ones, not ahead of them."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zeldaengine_tpu_torch")


def _py_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(PKG):
        if "_build" in base.split(os.sep):
            continue
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_package_layout_is_there():
    files = {os.path.relpath(f, ROOT) for f in _py_files()}
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
                 "zeldaengine_tpu_torch/livelink/server.py",
                 "zeldaengine_tpu_torch/livelink/client.py",
                 "zeldaengine_tpu_torch/livelink/editor.py",
                 "zeldaengine_tpu_torch/viewer.py",
                 "zeldaengine_tpu_torch/profiling.py",
                 "zeldaengine_tpu_torch/ops/envtap.py",
                 "zeldaengine_tpu_torch/scene/fbx.py"):
        assert want in files
    assert os.path.exists(os.path.join(PKG, "native", "zeldanative.cpp"))
    # The scan below covers the new sub-packages as their own cases.
    assert {"native", "meshlet", "tools", "livelink"} <= set(_groups())
    csrc = set(os.listdir(os.path.join(PKG, "csrc")))
    assert {"pair_raster.cu", "pair_raster_fused.cu", "pcf_taps.cu",
            "bilinear_tap.cu", "point_lights.cu", "pcf_window.cu",
            "pcf_window_table.cu", "fma.cu"} <= csrc
    # Every kernel registered with its wrapper has a C entry point bound.
    from zeldaengine_tpu_torch.ops import KERNEL_WRAPPERS, _build

    assert len(KERNEL_WRAPPERS) == 9
    for name in KERNEL_WRAPPERS:
        assert "zk_" + name in _build._SIGNATURES


def _groups():
    """The scanned sources by directory (one test case each)."""
    groups = {}
    for path in _py_files():
        rel = os.path.relpath(path, PKG)
        key = os.path.dirname(rel) if not rel.startswith("..") else ""
        groups.setdefault(key or "top_level_and_chip_smoke", []).append(path)
    return groups


@pytest.mark.parametrize("group", sorted(_groups()))
def test_source_imports_no_jax(group):
    paths = _groups()[group]
    assert paths
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "ml_dtypes",
                                   "zeldaengine_tpu"), (path, name)
