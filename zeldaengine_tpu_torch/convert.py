"""Carry a scene, a view or rasterizer state across as NumPy arrays.

Whoever holds the state of the JAX package (its tests, a tool) turns every
leaf into a NumPy array - bfloat16 leaves as float32, which is exact - and
hands the dict to these functions; both packages then compute on identical
inputs. This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from zeldaengine_tpu_torch.ops.rasterize import TriangleSetup
from zeldaengine_tpu_torch.ops.rasterize_cuda import PairedTriangles
from zeldaengine_tpu_torch.passes.view import HOST_LEAVES, ViewState
from zeldaengine_tpu_torch.scene.scenebuild import GpuScene
from zeldaengine_tpu_torch.utils.device import require_device

# GpuScene leaves the port stores as bfloat16 (they arrive as float32
# arrays holding bf16-exact values).
BF16_LEAVES = ("combined_atlas", "cube_atlas", "sky_tex", "bg_tex",
               "cube_pair1", "env_table")


def _tensor(a, device, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    arr = np.array(a)  # copies: the tensor never aliases the caller's array
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    t = torch.from_numpy(arr).to(device)
    return t if dtype is None else t.to(dtype)


def scene_from_numpy(leaves: Mapping[str, Optional[np.ndarray]],
                     device="cuda") -> GpuScene:
    """``GpuScene`` from a dict of NumPy leaves (missing optional leaves
    become None)."""
    device = require_device(device)
    fields = {}
    for name in GpuScene._fields:
        a = leaves.get(name)
        dtype = torch.bfloat16 if (name in BF16_LEAVES and a is not None) \
            else None
        fields[name] = _tensor(a, device, dtype)
    return GpuScene(**fields)


def view_from_numpy(leaves: Mapping[str, np.ndarray],
                    device="cuda") -> ViewState:
    """``ViewState`` from a dict of NumPy leaves; the host-side leaves
    (``passes.view.HOST_LEAVES``) stay on the CPU."""
    device = require_device(device)
    return ViewState(**{
        name: _tensor(leaves[name],
                      "cpu" if name in HOST_LEAVES else device)
        for name in ViewState._fields
    })


def setup_from_numpy(leaves: Mapping[str, Optional[np.ndarray]],
                     device="cuda") -> TriangleSetup:
    device = require_device(device)
    return TriangleSetup(**{
        name: _tensor(leaves.get(name), device)
        for name in TriangleSetup._fields
    })


def pairs_from_numpy(leaves: Mapping[str, np.ndarray],
                     device="cuda") -> PairedTriangles:
    """``PairedTriangles`` from the JAX package's leaves: its records are
    ``(n_slices, R, 128)`` slices (pair = slice * 128 + lane) and are
    transposed here into row-major ``(P, R)``. Records that are already
    2-D are taken as they are."""
    device = require_device(device)
    rec = np.asarray(leaves["records"], np.float32)
    if rec.ndim == 3:
        n_slices, rows, lanes = rec.shape
        rec = rec.transpose(0, 2, 1).reshape(n_slices * lanes, rows)
    return PairedTriangles(
        records=_tensor(np.ascontiguousarray(rec), device),
        pair_tri=_tensor(leaves["pair_tri"], device, torch.int32),
        starts=_tensor(leaves["starts"], device, torch.int32),
        ends=_tensor(leaves["ends"], device, torch.int32),
        sstarts=_tensor(leaves["sstarts"], device, torch.int32),
        sends=_tensor(leaves["sends"], device, torch.int32),
        gbounds=_tensor(leaves["gbounds"], device, torch.int32),
        overflow=_tensor(leaves.get("overflow", 0), device, torch.int32),
    )
