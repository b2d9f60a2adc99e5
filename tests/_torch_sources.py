"""The port's Python sources, grouped by directory, and the import scan
that holds them free of JAX: shared by tests/test_torch_no_jax*.py."""

import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zeldaengine_tpu_torch")
# Directories scanned by tests/test_torch_no_jax.py; the rest of the
# sorted groups by tests/test_torch_no_jax_more.py.
FIRST_GROUPS = 6


def py_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(PKG):
        if "_build" in base.split(os.sep):
            continue
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def groups():
    """The scanned sources by directory (one test case each)."""
    out = {}
    for path in py_files():
        rel = os.path.relpath(path, PKG)
        key = os.path.dirname(rel) if not rel.startswith("..") else ""
        out.setdefault(key or "top_level_and_chip_smoke", []).append(path)
    return out


def assert_imports_no_jax(group):
    paths = groups()[group]
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
