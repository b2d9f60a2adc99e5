"""A run's whole loop on the CPU at a tiny size, through the port's plain
versions: a well-formed result, no card named and no device metric."""

import json

import pytest

from frame_bench.harness import cell as cell_mod
from frame_bench.harness.cell import Run

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", ["tiny.orbit", "tinymesh.orbit",
                                  "tiny.stream"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_rehearsal_prints_a_well_formed_line(tiny_bench, few_warm_frames,
                                                 monkeypatch, cell, trace):
    bench, folder = tiny_bench
    # A CPU frame takes about a second: trace one.
    monkeypatch.setattr(cell_mod, "TRACE_SECONDS", 0.2)
    seconds = 1.0
    out = Run(bench, cell, 2**31 + 77, seconds, trace, device="cpu",
              bench_dir=folder).execute()
    line = json.loads(json.dumps(out))
    assert KEYS <= set(line)
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert line["device"] == dict(platform="cpu", kind="none", count=0,
                                  memory_peak_bytes=None)
    assert "breakdown" not in line
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    device_metrics = {m["name"] for m in bench["end_to_end"]
                      + bench["per_layer"] if m["source"] == "device_trace"}
    assert not set(line["metrics"]) & device_metrics
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if trace:
        assert "render_host_ms" in line["metrics"]
        assert "fps" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"fps", "setup_s"}
    for name, c in line["checked"].items():
        assert c["value"] <= c["limit"], name
