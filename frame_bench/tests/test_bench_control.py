"""The check's control, the reference with its raster computed in
bfloat16 put in the program's place, has to come out as not correct, and
so has the milder one with only its vertices in bfloat16: at a tiny size
on the CPU, and at each cell's own size on the card (three seeds each;
``frame_bench/control.py`` prints the readings)."""

import pytest

from frame_bench import control
from frame_bench.harness import spec


@pytest.mark.parametrize("mode", ["raster", "vertex"])
@pytest.mark.parametrize("cell", ["tiny.orbit", "tiny.stream",
                                  "tinymesh.orbit"])
def test_control_is_refused_at_a_tiny_size(tiny_bench, cell, mode):
    bench, folder = tiny_bench
    out = control.control_numbers(bench, cell, 5, "cpu", bench_dir=folder,
                                  mode=mode)
    assert out["refused"], out


@pytest.mark.card
@pytest.mark.parametrize("mode", ["raster", "vertex"])
@pytest.mark.parametrize("cell", ["demo1080.orbit", "meshlet1m.orbit"])
def test_control_is_refused_at_the_cells_size(card, cell, mode):
    bench = spec.load_benchmark()
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        out = control.control_numbers(bench, cell, seed, "cuda", mode=mode)
        assert out["refused"], out
