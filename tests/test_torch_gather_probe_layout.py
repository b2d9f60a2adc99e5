"""Kernel ``gather_probe``'s layouts and bounds
(``zeldaengine_tpu_torch/tools/gather_probe.py``): the counts a launch's
bounds are taken from, against hand counts; the plain version against the
JAX tool's kernel (root ``tools/pallas_gather_probe.py::make_kernel``) in
interpret mode at K 0, 3 and 33, bit for bit; the layout the wrapper picks
on either side of ``PRIVATE_MIN_K``, and the layout numbers against the
CUDA source; the SASS loop count on a hand-made listing."""

import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from zeldaengine_tpu_torch.tools import gather_probe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_probe_counts_and_bounds_by_hand():
    # The tool's 4096 tiles: 4096 * 8 * 128 elements, 12 bytes each.
    c = gather_probe.probe_counts(4096, 128)
    assert c == dict(elements=4_194_304, bytes=50_331_648,
                     gathers=536_870_912, wavefronts=16_777_216)
    assert gather_probe.probe_counts(1, 0) == dict(
        elements=1024, bytes=12_288, gathers=0, wavefronts=0)
    assert gather_probe.probe_counts(2, 3)["wavefronts"] == 2 * 1024 * 3 // 32
    # 132 SMs at 1,980 MHz serve 261.36 G wavefronts/s; 3.35 TB/s.
    b = gather_probe.probe_bounds(c, 132, 1.98e9)
    assert b["smem_bound_ms"] == pytest.approx(0.064192, rel=1e-4)
    assert b["byte_bound_ms"] == pytest.approx(0.015024, rel=1e-4)
    assert b["bound_by"] == "shared memory"
    b1 = gather_probe.probe_bounds(gather_probe.probe_counts(4096, 1), 132,
                                   1.98e9)
    assert b1["smem_bound_ms"] == pytest.approx(0.064192 / 128, rel=1e-4)
    assert b1["bound_by"] == "bytes"


@pytest.mark.parametrize("axis", [1, 0])
def test_plain_matches_the_pallas_probe_at_odd_k(axis, monkeypatch):
    """2 tiles, K 0, 3 and 33 (the kernel's unrolled loop ends in its
    remainder at 3 and 33): ``pl.pallas_call(..., interpret=True)`` as the
    JAX tool's ``bench`` builds it."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec_file = importlib.util.spec_from_file_location(
        "_jax_tool_pallas_gather_probe",
        os.path.join(ROOT, "tools", "pallas_gather_probe.py"))
    tool = importlib.util.module_from_spec(spec_file)
    spec_file.loader.exec_module(tool)
    t, idx = gather_probe.probe_inputs(2, axis, seed=axis + 11)
    spec = pl.BlockSpec(gather_probe.TILE, lambda i: (i, 0))
    for k in (0, 3, 33):
        fn = jax.jit(pl.pallas_call(
            tool.make_kernel(k, axis), grid=(2,),
            in_specs=[spec, spec], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
            interpret=True))
        want = np.asarray(fn(t.numpy(), idx.numpy()))
        got = gather_probe.gather_probe(t, idx, k, axis).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=str(k))
    assert not got.any() if k == 0 else got.any()


def test_layout_choice_at_the_constant():
    k = gather_probe.PRIVATE_MIN_K
    assert k > 1
    assert gather_probe.layout(1, k - 1) == "lane_shared"
    assert gather_probe.layout(1, k) == "lane_private"
    assert gather_probe.layout(1, 128) == "lane_private"
    assert gather_probe.layout(0, k - 1) == gather_probe.layout(0, k) \
        == "sublane"
    for axis, names in gather_probe.AXIS_LAYOUTS.items():
        assert {gather_probe.layout(axis, 1),
                gather_probe.layout(axis, 128)} <= set(names)
    with pytest.raises(ValueError):
        gather_probe.layout(2, 1)


def test_layout_numbers_match_the_source():
    src = open(os.path.join(ROOT, "zeldaengine_tpu_torch", "csrc",
                            "gather_probe.cu")).read()
    enum = re.search(r"enum Layout : int \{([^}]*)\}", src).group(1)
    found = {name: int(v) for name, v in re.findall(r"k(\w+) = (\d+)", enum)}
    assert found == {"Sublane": 0, "LaneShared": 1, "LanePrivate": 2}
    assert gather_probe.LAYOUTS == {"sublane": 0, "lane_shared": 1,
                                    "lane_private": 2}


def test_sass_loops_on_a_listing():
    """Two functions in ``cuobjdump -sass`` form: the innermost loop with
    the most FADD is read, its instructions counted by opcode."""
    head = ("\t\tFunction : _ZN4_GLOBAL__N_119gather_probe_kernelILi{}"
            "EEEvPKfPKiPfii\n")
    body0 = """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   IADD3 R2, R2, R3, RZ ;
        /*0020*/                   LOP3.LUT R4, R2, 0xe00, R5, 0xf8, !PT ;
        /*0030*/                   LDS R6, [R4+0x80] ;
        /*0040*/                   LEA.HI R7, R2, R5, RZ, 0xc ;
        /*0050*/                   LDS R8, [R7] ;
        /*0060*/                   FADD R9, R9, R6 ;
        /*0070*/                   FADD R10, R10, R8 ;
        /*0080*/               @P0 BRA 0x10 ;
        /*0090*/                   LDS R6, [R4] ;
        /*00a0*/                   FADD R9, R9, R6 ;
        /*00b0*/              @!P1 BRA 0x90 ;
        /*00c0*/                   EXIT ;
"""
    body2 = """
        /*0000*/                   LDS R1, [R2] ;
        /*0010*/                   STS [R3], R1 ;
        /*0020*/                   LDS R4, [R2+0x4] ;
        /*0030*/               @P0 BRA 0x0 ;
        /*0040*/                   EXIT ;
"""
    text = ("\tcode for sm_90a\n" + head.format(0) + body0 + head.format(2)
            + body2 + head.format(128) + body2)
    loops = gather_probe.sass_loops(text)
    # An older source's template argument keeps its number.
    assert set(loops) == {"sublane", "lane_private",
                          "gather_probe_kernel<128>"}
    sub = loops["sublane"]
    assert sub["opcodes"] == {"IADD3": 1, "LOP3": 1, "LDS": 2, "LEA": 1,
                              "FADD": 2, "BRA": 1}
    assert (sub["lds"], sub["fadd"], sub["instructions"]) == (2, 2, 8)
    assert sub["per_gather"] == 4.0
    assert loops["lane_private"]["fadd"] == 0


def test_cli_rows_carry_layout_and_counts_on_the_cpu(capsys):
    rows = gather_probe.probe(n_blocks=1, reps=1, device="cpu")
    assert [(r["axis"], r["k"]) for r in rows] == [
        (a, k) for a in (1, 0) for k in gather_probe.K_OPS]
    for r in rows:
        assert r["layout"] == gather_probe.layout(r["axis"], r["k"])
        assert r["wavefronts"] == r["k"] * 1024 // 32
        assert r["bytes"] == 12 * 1024
        # No bound without a card.
        assert r["smem_bound_ms"] is None and r["share"] is None
