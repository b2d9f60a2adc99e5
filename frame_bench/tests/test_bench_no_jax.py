"""Nothing the harness or the reference loads is JAX or the JAX package,
and the reference loads nothing of the port: compared by whole top-level
module names (``zeldaengine_tpu_torch`` begins with ``zeldaengine_tpu``)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from frame_bench.harness import guard

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "frame_bench"
PROGRAM = "zeldaengine_tpu_torch"


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded([PROGRAM, PROGRAM + ".engine"]) == []
    assert guard.forbidden_loaded(["zeldaengine_tpu.passes", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "zeldaengine_tpu"]


def test_the_reference_loads_neither_jax_nor_the_program():
    loaded = _loaded(
        "import frame_bench.reference.render, frame_bench.control\n"
        "import frame_bench.reference.raster")
    assert not loaded & (guard.FORBIDDEN | {PROGRAM})


def test_the_harness_loads_no_jax():
    loaded = _loaded(
        "import frame_bench.harness.cell, frame_bench.harness.check\n"
        "import zeldaengine_tpu_torch.engine\n"
        "import zeldaengine_tpu_torch.passes.frame\n"
        "import zeldaengine_tpu_torch.meshlet\n"
        "from frame_bench.harness import spec\n"
        "for m in spec.load_benchmark()['per_layer']:\n"
        "    spec.load_reader(m['name'])")
    assert PROGRAM in loaded
    assert not loaded & guard.FORBIDDEN


# The benchmark's own sources: not the run caches or unpacked checkouts
# (``_cache/``, ``_checkout/``, git-ignored).
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if not p.relative_to(BENCH).parts[0].startswith("_"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    names = _imports(path)
    assert not names & guard.FORBIDDEN
    if "reference" in path.parts:
        assert PROGRAM not in names


def test_run_refuses_without_a_card():
    """run.py exits non-zero and prints no result where torch sees fewer
    cards than the cell asks for (here: none)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "frame_bench/run.py", "--workload",
         "demo1080.orbit", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_run_needs_the_program(tmp_path):
    """In a folder holding only BENCHMARK.json and frame_bench/, a run
    exits non-zero and prints no result (without a card it stops at the
    card; on the card, at the missing program)."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "frame_bench",
                    ignore=shutil.ignore_patterns("_cache", "_checkout",
                                                  "__pycache__"))
    out = subprocess.run(
        [sys.executable, "frame_bench/run.py", "--workload",
         "demo1080.orbit", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
