"""Where a cell's pieces live, found by name.

- the cells, metrics and run length: ``BENCHMARK.json`` at the checkout's
  root;
- a configuration: ``frame_bench/configs/<name>.json``;
- a traffic mix: ``frame_bench/traffic/<name>.json``;
- a per-layer metric: ``frame_bench/metrics/<name>.py``, a module with
  ``read(run) -> float | None``.

A later change that adds a configuration, a mix or a metric adds files and
``BENCHMARK.json`` entries and edits none of these modules.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _named(folder: Path, name: str, suffix: str) -> Path:
    path = folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return path


def config_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return _named(Path(bench_dir) / "configs", name, ".json")


def traffic_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return _named(Path(bench_dir) / "traffic", name, ".json")


def metric_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return _named(Path(bench_dir) / "metrics", name, ".py")


def load_config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads(config_path(name, bench_dir).read_text())


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads(traffic_path(name, bench_dir).read_text())


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of metric ``name``'s module."""
    path = metric_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        f"frame_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those without a ``workloads`` list and those that name it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def resolve(bench: dict, cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """Every file a cell needs, by name; raises on the first one missing."""
    cell = find_cell(bench, cell_name)
    return dict(
        cell=cell,
        config=config_path(cell["config"], bench_dir),
        traffic=traffic_path(cell["traffic"], bench_dir),
        metrics={m["name"]: metric_path(m["name"], bench_dir)
                 for m in cell_metrics(bench, cell_name, "per_layer")})
