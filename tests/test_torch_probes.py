"""The probe tools of the port (``zeldaengine_tpu_torch/tools/
gather_probe.py``, ``walk_stats.py``): the plain versions of kernels
``gather_probe`` and ``fma_peak`` against the JAX package's probe kernels
(root ``tools/pallas_gather_probe.py::make_kernel`` and the kernel
``tools/walk_stats.py::vpu_micro`` builds) run in interpret mode on the
same seeded inputs, bit for bit; the walk count on a small demo frame's
GBuffer pairs; the wrappers' refusal of ``backend="cuda"`` on the CPU."""

import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zeldaengine_tpu_torch import TEST_CONFIG
from zeldaengine_tpu_torch.ops import rasterize_cuda as rc
from zeldaengine_tpu_torch.passes import frame as frame_graph
from zeldaengine_tpu_torch.scene import build_demo_scene
from zeldaengine_tpu_torch.tools import gather_probe, walk_stats

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCKS = 4


def _tool(name, monkeypatch):
    """Root ``tools/<name>.py`` loaded by path (the tool edits sys.path
    when imported: a copy of it is restored after the test)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("axis", [1, 0])
def test_gather_probe_plain_matches_the_pallas_probe(axis, monkeypatch):
    """T1 at 4 tiles, K 1, 8 and 32: the JAX tool's kernel through
    ``pl.pallas_call(..., interpret=True)`` as its ``bench`` builds it."""
    tool = _tool("pallas_gather_probe", monkeypatch)
    t, idx = gather_probe.probe_inputs(N_BLOCKS, axis, seed=axis + 5)
    spec = pl.BlockSpec(gather_probe.TILE, lambda i: (i, 0))
    for k in (1, 8, 32):
        fn = jax.jit(pl.pallas_call(
            tool.make_kernel(k, axis), grid=(N_BLOCKS,),
            in_specs=[spec, spec], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
            interpret=True))
        want = np.asarray(fn(t.numpy(), idx.numpy()))
        got = gather_probe.gather_probe(t, idx, k, axis).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=str(k))
    # K 8 differs from K 1 by the other seven scrambled gathers.
    assert not np.array_equal(
        gather_probe.gather_probe(t, idx, 1, axis).numpy(), got)


def test_fma_peak_plain_matches_vpu_micro(monkeypatch):
    """T2 at n_ops 8 on 2 steps of (256, 128), C = 1, 3 and 8: the jitted
    function ``vpu_micro`` builds, caught at ``jax.jit`` with
    ``pl.pallas_call`` in interpret mode, on a seeded input."""
    tool = _tool("walk_stats", monkeypatch)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    caught = []
    jit = jax.jit

    def catch(fn, *args, **kw):
        caught.append(fn)
        return jit(fn, *args, **kw)

    monkeypatch.setattr(jax, "jit", catch)
    a = np.random.default_rng(3).uniform(
        -2.0, 2.0, (2 * 256, 128)).astype(np.float32)
    for chains in walk_stats.CHAINS:
        caught.clear()
        assert tool.vpu_micro(n_ops=8, steps=2, reps=1, chains=chains) > 0
        want = np.asarray(jit(caught[-1])(a))
        got = walk_stats.fma_peak(torch.from_numpy(a), chains, 8).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32),
                                      err_msg=str(chains))


def test_walk_stats_counts_the_frame_gbuffer_pairs():
    """On a small demo frame: the pairs ``gbuffer_pass`` takes are the ones
    the frame's GBuffer pass bins (its second ``build_pairs`` call, after
    the shadow pass), and the count is ``strip_walk_tests`` times
    ``OPS_PER_TEST``."""
    config = TEST_CONFIG.replace(width=96, height=64)
    scene, meta, world = build_demo_scene(config, grass=20, rocks=2,
                                          device="cpu")
    built = []
    build = frame_graph.build_pairs

    def note(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frame_graph, "build_pairs", note)
        pairs, height, width, kw = walk_stats.gbuffer_pass(
            scene, meta, world, config)
    assert len(built) == 2 and built[1].records is pairs.records
    assert (height, width) == (64, 128)  # rows to tiles, columns to 128
    assert kw["y_row"] >= 0 and int(pairs.gbounds[1]) > 0
    load = walk_stats.walk_load(pairs, height, width, kw)
    tests = int(rc.strip_walk_tests(
        pairs, height, width, kw["tile_h"], kw["tile_w"], kw["sub_rows"],
        kw["y_row"]).sum())
    assert load["pixel_pair_tests"] == tests > 0
    assert load["elem_ops"] == tests * walk_stats.OPS_PER_TEST
    assert load["live_pairs"] == int(pairs.gbounds[1])
    assert load["record_bytes"] == 64 * load["tile_pair_entries"]
    rates = {c: dict(fma_ops_per_s=1e9 * c) for c in walk_stats.CHAINS}
    out = walk_stats.report("demo", pairs, height, width, kw, rates,
                            k2_reps=1)
    assert out["floor_ms"] == load["elem_ops"] / 8e9 * 1e3
    assert out["k2_ms"] > 0 and out["k2_over_floor"] > 0


def test_gather_probe_cli_on_the_cpu(capsys):
    assert gather_probe.main(["--device", "cpu", "--blocks", "2",
                              "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    got = [(r["axis"], r["k"]) for r in out["results"]]
    assert got == [(a, k) for a in (1, 0) for k in gather_probe.K_OPS]
    assert out["device"].startswith("cpu")


def test_probe_wrappers_refuse_cuda_on_the_cpu():
    t, idx = gather_probe.probe_inputs(1, 1)
    with pytest.raises(RuntimeError, match="card"):
        gather_probe.gather_probe(t, idx, 1, 1, backend="cuda")
    with pytest.raises(RuntimeError, match="card"):
        walk_stats.fma_peak(t, 1, backend="cuda")
    with pytest.raises(ValueError):
        walk_stats.fma_peak(t, 2)
    with pytest.raises(ValueError):
        gather_probe.gather_probe(t, idx, 1, 2)
