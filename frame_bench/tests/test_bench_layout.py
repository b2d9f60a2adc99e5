"""BENCHMARK.json against the files it names, and the data-driven layout:
every cell resolves by name, and a configuration, traffic or metric file
dropped into the folder is found with no code edit."""

import json
import re

import pytest

from frame_bench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_to_its_files():
    bench = spec.load_benchmark()
    for cell in bench["workloads"]:
        found = spec.resolve(bench, cell["name"])
        assert found["config"].is_file() and found["traffic"].is_file()
        for path in found["metrics"].values():
            assert path.is_file()
        cfg = spec.load_config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert cfg["entry"] in ("engine_tick", "render_frame")
        assert "camera" in spec.load_traffic(cell["traffic"])


def test_every_metric_has_a_reader():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))


def test_benchmark_json_keeps_the_contract_shape():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["frame_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("frame_bench/")
        assert c["name"] in {w["config"] for w in bench["workloads"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)
        layers.add(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
    for n in names + cells + [m["name"] for m in
                              bench["end_to_end"] + bench["per_layer"]]:
        assert NAME.match(n), n
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_dropped_in_config_traffic_and_metric_are_found(tmp_path):
    """Files added to a copy of the folder, and a cell naming them, resolve
    through the same functions, with no code edit."""
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "newcfg.json").write_text(json.dumps(
        {"name": "newcfg", "entry": "render_frame"}))
    (tmp_path / "traffic" / "newmix.json").write_text(json.dumps(
        {"camera": {"yaw_step_deg": 2.0, "start_yaw_deg": [0, 90]}}))
    (tmp_path / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = {"workloads": [dict(name="newcfg.newmix", config="newcfg",
                                traffic="newmix", chips=1, why="t")],
             "end_to_end": [], "per_layer": [
                 dict(name="new_metric", unit="x", better="lower",
                      source="host_clock", layer="l", moves="fps")]}
    found = spec.resolve(bench, "newcfg.newmix", tmp_path)
    assert found["config"] == tmp_path / "configs" / "newcfg.json"
    assert found["traffic"] == tmp_path / "traffic" / "newmix.json"
    assert list(found["metrics"]) == ["new_metric"]
    assert spec.load_reader("new_metric", tmp_path)(None) == 42.0
    assert spec.load_traffic("newmix", tmp_path)["camera"]["yaw_step_deg"] \
        == 2.0


def test_a_missing_file_is_named():
    bench = {"workloads": [dict(name="x.y", config="absent", traffic="orbit",
                                chips=1, why="t")], "per_layer": []}
    with pytest.raises(FileNotFoundError, match="absent.json"):
        spec.resolve(bench, "x.y")
