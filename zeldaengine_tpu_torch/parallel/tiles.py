"""Multi-device rendering: screen rows split over a list of devices.

The split-frame design of the JAX package's ``parallel/tiles.py``: the
screen is the data-parallel axis. Scene pools are replicated (read-only
and small beside a card's memory); each device rasterizes and shades its
own rows of the frame, so the O(pixels x triangles) raster and the
O(pixels x lights) resolve divide over the devices. The shadow map is
built as bands too, one per device, then gathered onto every device
(every band of the screen taps the whole map).

Where the JAX package runs one program per device under ``shard_map``,
this is one process issuing each device's work in turn on an explicit
list of ``torch.device``s: the "all_gather" is a ``torch.cat`` of every
shadow band copied to each device, and the image is gathered onto the
first device. A device may be listed more than once: ``[cuda:0] * 4``
renders four bands in turn on one card, ``[cpu] * 8`` is the CPU analogue
of the JAX package's eight virtual CPU devices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.math.transforms import (
    apply_mat4_h, apply_mat4_point)
from zeldaengine_tpu_torch.ops.rasterize import triangle_setup
from zeldaengine_tpu_torch.passes.frame import (
    _band_mask_setup, render_rows, render_shadow_band)
from zeldaengine_tpu_torch.passes.view import HOST_LEAVES
from zeldaengine_tpu_torch.scene.scenebuild import GpuScene, SceneMeta

AXIS = "rows"


class TileMesh(NamedTuple):
    """The devices that render the frame's rows, in band order, and the
    name of the axis they split (the JAX mesh's one axis)."""

    devices: tuple
    axis: str = AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_tile_mesh(devices: Optional[Sequence] = None) -> TileMesh:
    """A ``TileMesh`` over ``devices`` (``torch.device``s or names; a device
    may repeat), by default every visible CUDA device. Raises when no card
    is visible and no devices are given."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_tile_mesh: no CUDA device is visible; "
                               "pass the devices explicitly")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_tile_mesh: no devices")
    return TileMesh(devices)


def band_compact_config(config: EngineConfig, meta: SceneMeta, n: int,
                        slack: float = 2.0) -> EngineConfig:
    """Size live-triangle compaction to a band's share: each band's pair
    binning runs after the band mask (``passes/frame.py::_band_mask_setup``),
    so compacting to ``slack * T / n`` slots makes its cost track the
    band's triangle count instead of the whole scene's. ``slack`` absorbs
    uneven screen distributions; a band holding more live triangles than
    the cap drops the highest ids (counted in ``aux["pair_overflow"]``).
    A config that sets ``compact_tris`` itself is kept."""
    if config.compact_tris is not None:
        return config
    t = max(int(meta.num_triangles), 1)
    cap = max(1024, -(-int(slack * t / max(n, 1)) // 128) * 128)
    if cap >= t:
        return config  # no saving at this scale
    return config.replace(compact_tris=cap)


def stripe_layout(config: EngineConfig, n: int):
    """Striped row assignment: device d owns tile rows d, d + n, d + 2n, ...
    (``config.tile_h`` pixel rows each). Returns (S strips a device, strip
    height in rows, padded tile rows S * n). Contiguous bands put most of
    the work on whichever device owns mid-screen; stripes interleave the
    content across devices at tile granularity."""
    th = config.tile_h
    n_trows = -(-config.height // th)
    s = -(-n_trows // n)
    return s, th, s * n


def unstripe_perm(config: EngineConfig, n: int) -> torch.Tensor:
    """Row permutation (int64, on the host) taking the strip-major
    device-major output back to screen order: screen tile row t was
    rendered by device t % n as its strip t // n."""
    s, th, _ = stripe_layout(config, n)
    t = np.arange(n * s)
    src_row = ((t % n) * s + t // n)[:, None] * th + np.arange(th)[None]
    return torch.from_numpy(src_row.reshape(-1)[: n * s * th].astype(
        np.int64))


def _to_device(state, device):
    """A copy of a NamedTuple of tensors with every tensor leaf on
    ``device`` (the view's host leaves stay on the host)."""
    return state._replace(**{
        k: v.to(device) for k, v in state._asdict().items()
        if isinstance(v, torch.Tensor) and k not in HOST_LEAVES})


def _replicas(scene, view, mesh: TileMesh) -> dict:
    """{device: (scene, view)}, one copy per distinct device."""
    return {d: (_to_device(scene, d), _to_device(view, d))
            for d in dict.fromkeys(mesh.devices)}


def _gathered_shadowmaps(reps: dict, meta, config: EngineConfig,
                         mesh: TileMesh):
    """Each device renders its band of the shadow map, rows
    [d * D / n, (d + 1) * D / n); every distinct device gets the (D, D) map
    of all bands in order (the JAX package's all_gather). None without
    shadows."""
    if not config.enable_shadow:
        return {d: None for d in reps}
    n = mesh.size
    s_rows = config.shadowmap_dim // n
    bands = []
    for i, d in enumerate(mesh.devices):
        scene_d, view_d = reps[d]
        bands.append(render_shadow_band(scene_d, view_d, meta, config,
                                        i * s_rows, s_rows))
    return {d: torch.cat([b.to(d) for b in bands], 0) for d in reps}


@torch.no_grad()
def render_frame_sharded(
    scene: GpuScene,
    view,
    meta: SceneMeta,
    config: EngineConfig,
    mesh: TileMesh,
    band_compact_slack: float | None = None,
    stripe: bool = True,
):
    """Render one frame with its pixel rows split over ``mesh``.

    Returns the (H, W, 3) image in screen order on ``mesh.devices[0]``.
    ``band_compact_slack`` opts into band-sized compaction
    (``band_compact_config``).

    ``stripe`` (default): device d renders tile rows d, d + n, d + 2n, ...
    as S strips of one tile row (``stripe_layout``; strips past the last
    row render nothing and are cropped), each through ``render_rows`` on
    the gathered shadow map (``shadowmap_override``), and the strip-major
    output is permuted back to screen order. ``stripe=False``: contiguous
    bands of H / n rows, at any row (K1/K2 render the whole tile rows that
    hold a band, which is cropped out of them). Either way each device
    first renders its own band of the shadow map, D / n rows."""
    n = mesh.size
    if config.shadowmap_dim % n:
        raise ValueError(f"shadowmap_dim {config.shadowmap_dim} does not "
                         f"divide over {n} devices")
    if band_compact_slack is not None:
        config = band_compact_config(config, meta, n,
                                     slack=band_compact_slack)
    reps = _replicas(scene, view, mesh)
    maps = _gathered_shadowmaps(reps, meta, config, mesh)
    first = mesh.devices[0]

    def rows_of(d, y0, rows):
        scene_d, view_d = reps[d]
        color, _aux = render_rows(scene_d, view_d, meta, config, y0=y0,
                                  rows=rows, full_frame=False,
                                  shadowmap_override=maps[d])
        return color.to(first)

    if not stripe:
        if config.height % n:
            raise ValueError(f"height {config.height} does not divide over "
                             f"{n} devices")
        rows = config.height // n
        return torch.cat([rows_of(d, i * rows, rows)
                          for i, d in enumerate(mesh.devices)], 0)

    n_strips, th, _ = stripe_layout(config, n)
    out = torch.cat([rows_of(d, (i + s * n) * th, th)
                     for i, d in enumerate(mesh.devices)
                     for s in range(n_strips)], 0)  # device-major strips
    perm = unstripe_perm(config, n).to(first)
    return out[perm][: config.height]


def jit_sharded_renderer(meta: SceneMeta, config: EngineConfig,
                         mesh: TileMesh,
                         band_compact_slack: float | None = None):
    """A closure over the static scene meta, config and mesh, named after
    the JAX package's jitted one: ``step(scene, view)`` renders one frame
    with ``render_frame_sharded``. Nothing is compiled; each call issues
    its kernels eagerly."""

    def step(scene, view):
        return render_frame_sharded(scene, view, meta, config, mesh,
                                    band_compact_slack=band_compact_slack)

    return step


@torch.no_grad()
def band_pair_stats(scene, view, meta, config: EngineConfig, mesh: TileMesh,
                    stripe: bool = True) -> np.ndarray:
    """Per device (band-live triangles, band pair count) of the deferred
    pass, an (n, 2) int array: the measure of how evenly the bands share
    the binning work (``tools/stripe_balance.py`` asks max / mean <= 1.5
    of the striped layout). Follows ``render_rows``' vertex stage and
    setup for the deferred pass (without the meshlet cull); with
    ``stripe`` the counts sum each device's strips (a triangle spanning k
    of them counts k times, as its binning does)."""
    dev = scene.pair_pos.device
    world = apply_mat4_point(view.model, scene.pair_pos)
    clip = apply_mat4_h(view.view_proj, world)
    setup0 = triangle_setup(
        clip[scene.tri_vtx.long()], config.width, config.height,
        two_sided=scene.tri_two_sided,
        valid_mask=scene.tri_valid & scene.tri_deferred)
    th, tw = config.tile_h, config.tile_w
    n_tx = -(-config.width // tw)
    n = mesh.size

    def counts(y0, rows):
        setup = _band_mask_setup(setup0, y0, rows)
        b = setup.bbox
        live = setup.valid & (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        n_ty = -(-(y0 % th + rows) // th)  # passes/frame.py::_band_tiles
        y0t = float(y0 // th)  # band origin in tile rows
        tx0 = torch.clamp(torch.floor(b[:, 0] / tw), 0, n_tx - 1)
        tx1 = torch.clamp(torch.ceil(b[:, 2] / tw) - 1.0, 0, n_tx - 1)
        ty0 = torch.clamp(torch.floor(b[:, 1] / th) - y0t, 0, n_ty - 1)
        ty1 = torch.clamp(torch.ceil(b[:, 3] / th) - 1.0 - y0t, 0, n_ty - 1)
        ncov = torch.where(live, (tx1 - tx0 + 1) * (ty1 - ty0 + 1),
                           torch.zeros_like(tx0))
        return torch.stack([live.sum().to(torch.float64),
                            ncov.to(torch.float64).sum()])

    out = torch.zeros((n, 2), dtype=torch.float64, device=dev)
    if stripe:
        n_strips, _, _ = stripe_layout(config, n)
        for i in range(n):
            for s in range(n_strips):
                out[i] += counts((i + s * n) * th, th)
    else:
        rows = config.height // n
        for i in range(n):
            out[i] = counts(i * rows, rows)
    return out.cpu().numpy().astype(int)
