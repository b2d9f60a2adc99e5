"""Tests of the frame benchmark (``frame_bench/``), run by

    python -m pytest frame_bench/tests -q

on the CPU at tiny sizes; tests marked ``card`` need the NVIDIA card and
skip without one (decided inside the fixture, never at import), and run
on the card by the same command."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"
BENCH = ROOT / "frame_bench"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.fixture
def tiny_bench(tmp_path):
    """A benchmark folder of the tiny test configurations beside copies of
    the real traffic and metric files, and a BENCHMARK.json of its cells:
    (bench dict, folder)."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, tmp_path / sub)
    for path in DATA.glob("*.json"):
        shutil.copy(path, tmp_path / "configs" / path.name)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        dict(name="tiny.orbit", config="demo_tiny", traffic="orbit",
             chips=1, why="tests"),
        dict(name="tiny.stream", config="demo_tiny", traffic="stream",
             chips=1, why="tests"),
        dict(name="tinymesh.orbit", config="mesh_tiny", traffic="orbit",
             chips=1, why="tests"),
    ]
    for m in bench["per_layer"]:
        m["workloads"] = [w["name"] for w in bench["workloads"]]
    return bench, tmp_path


@pytest.fixture
def few_warm_frames(monkeypatch):
    from frame_bench.harness import cell
    monkeypatch.setattr(cell, "WARM_FRAMES", 2)
