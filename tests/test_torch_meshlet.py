"""The port's meshlet tooling against the JAX package's, bit for bit: the
native clusterizer (both packages' copies of zeldanative.cpp, built with
the same g++ command) and the NumPy clusterizer, and the .meshlet files and
the meshletgen CLI. The OBJ loaders are in test_torch_meshlet_obj.py, the
cull masks in test_torch_meshlet_cull.py."""

import jax
import numpy as np
import pytest
import torch

import zeldaengine_tpu.native as j_native
from zeldaengine_tpu.meshlet import build_meshlets as j_build_meshlets
from zeldaengine_tpu.meshlet import load_meshlet_set as j_load
from zeldaengine_tpu.meshlet import save_meshlet_set as j_save
from zeldaengine_tpu.tools.meshletgen import main as j_meshletgen
from zeldaengine_tpu_torch import native
from zeldaengine_tpu_torch.meshlet import (
    build_meshlets, load_meshlet_set, save_meshlet_set)
from zeldaengine_tpu_torch.tools.meshletgen import main as meshletgen

from _torch_meshlet_inputs import _MESHES, _sphere, _set_arrays, _obj_text

torch.set_num_threads(1)


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_builders_match_the_reference_bit_for_bit(mesh, backend,
                                                  monkeypatch):
    """The native builders of both packages (each built from its own copy
    of the source with the same command) agree bit for bit, and so do the
    NumPy builders; the two builders are never compared with each other
    (their bounds differ)."""
    pos, idx, kw = _MESHES[mesh]()
    if backend == "numpy":
        # The JAX package takes its NumPy path only when the native one
        # gives nothing.
        monkeypatch.setattr(j_native, "build_meshlets_native",
                            lambda *a, **k: None)
    else:
        native.load()
        assert native.available() and j_native.available()
        assert native.CXX_FLAGS == ["-O3", "-march=native", "-shared",
                                    "-fPIC", "-std=c++17"]
        assert native.library_path().parent.parent == native.BUILD_ROOT
    want = _set_arrays(j_build_meshlets(pos, idx, **kw))
    got = _set_arrays(build_meshlets(pos, idx, backend=backend, **kw))
    assert want["records"].shape[0] > 4
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_meshlet_files_and_meshletgen_equal_the_reference(tmp_path):
    """Files cross-read between the packages and rewritten are the same
    bytes; the two meshletgen CLIs write the same bytes from one OBJ."""
    pos, idx = _sphere(0.8, 20, 30)
    ms = build_meshlets(pos, idx)
    a, b = str(tmp_path / "a.meshlet"), str(tmp_path / "b.meshlet")
    save_meshlet_set(a, ms)
    j_save(b, j_load(a))
    save_meshlet_set(str(tmp_path / "c.meshlet"), load_meshlet_set(b))
    blobs = [open(str(tmp_path / n), "rb").read()
             for n in ("a.meshlet", "b.meshlet", "c.meshlet")]
    assert blobs[0] == blobs[1] == blobs[2]
    back = load_meshlet_set(a)
    np.testing.assert_array_equal(back.arrays(), ms.arrays())
    with open(a, "rb") as f:
        head = f.read(100)
    cut = str(tmp_path / "cut.meshlet")
    with open(cut, "wb") as f:
        f.write(head)
    with pytest.raises(ValueError, match="truncated"):
        load_meshlet_set(cut)

    obj = str(tmp_path / "grid.obj")
    with open(obj, "w") as f:
        f.write(_obj_text(True))
    outs = []
    for name, cli in (("port", meshletgen), ("jax", j_meshletgen)):
        out = str(tmp_path / f"{name}.meshlet")
        assert cli(["-i", obj, "-o", out, "-v", "16", "-t", "8"]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and len(outs[0]) > 64
