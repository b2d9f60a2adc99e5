"""Merged environment tap: cubemap reflection + skydome + background in
ONE row fetch per pixel.

Every pixel needs exactly one environment fetch: covered pixels sample
the IBL cubemap along the refraction vector (Base.frag:104-112), and
uncovered pixels sample the skydome equirect (or the background rect,
Background.frag) - never both. The three tables are merged into one and
the row index is selected per pixel, so the frame's environment gathers
become one.

Table layout (row width = 4 * 13 * 4 = 208 channels, bf16):
  [0, cube_rows)       quad+pair cubemap faces: one row serves a full
                       trilinear sample (``build_quad_pair_atlas_np``)
  [cube_rows, +sky)    quad-packed sky equirect rows, channel-padded
  [.., +bg)            quad-packed background rows, channel-padded

The row counts are static per scene (``SceneMeta.env_shapes``). Same
index math, selects and lerp order as the JAX package's ``ops/envtap.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zeldaengine_tpu_torch.ops.texture import (
    cube_direction_to_face_uv,
    mip_count,
    pair_filter_row,
    pair_row_context,
    quad_filter_row,
    quad_row_context,
    quad_select,
)

ENV_CH = 208  # 4 quad bases x 13 pair groups x 4 channels (cube RGBA)


def flatten_env_tables(cube_qp, sky_quad, bg_quad):
    """Concatenate the three atlases into one (R, ENV_CH) table.

    cube_qp: (6, S, S/2, 208); sky_quad / bg_quad: (1, Ss, Ss/2, 64).
    Returns (table, (cube_rows, sky_rows, bg_rows))."""

    def rows(a):
        return a.reshape(-1, a.shape[-1])

    def pad(a):
        return F.pad(rows(a), (0, ENV_CH - a.shape[-1]))

    cube_r = rows(cube_qp)
    sky_r = pad(sky_quad)
    bg_r = pad(bg_quad)
    table = torch.cat([cube_r, sky_r, bg_r], dim=0)
    return table, (cube_r.shape[0], sky_r.shape[0], bg_r.shape[0])


def sample_env_merged(
    env_table,      # (R, ENV_CH)
    env_shapes,     # ((6, S, S/2), (1, Ss, Ss/2), (1, Sb, Sb/2)) static
    covered,        # (H, W) bool
    refl_dir,       # (H, W, 3)
    refl_lod,       # (H, W)
    cube_base: int,
    sky_uv,         # (H, W, 2)
    use_sky,        # (H, W) bool (uncovered & dome hit); else background
    bg_uv,          # (H, W, 2) or None
    sky_base: int,
    bg_base: int,
):
    """One row fetch for reflection + sky + background.

    Returns (refl_rgba (H, W, 4), sky_rgba, bg_rgba), each valid only
    where its selector chose that slot (masked downstream)."""
    (c_n, c_h, c_wq), (s_n, s_h, s_wq), (b_n, b_h, b_wq) = env_shapes
    cube_rows = c_n * c_h * c_wq
    sky_rows = s_n * s_h * s_wq
    dev = refl_dir.device

    # Cubemap: direction -> face/uv, clamped per mip as sample_cubemap_lod.
    face, cuv = cube_direction_to_face_uv(refl_dir)
    lod = torch.as_tensor(refl_lod, dtype=torch.float32, device=dev)
    size_f = torch.clamp_min(
        torch.tensor(float(cube_base), dtype=torch.float32, device=dev)
        / torch.exp2(torch.clamp(torch.floor(lod), 0,
                                 mip_count(cube_base) - 1)), 1.0)
    half = (0.5 / size_f)[..., None]
    cuv = torch.minimum(torch.maximum(cuv, half), 1.0 - half)
    c_layer, c_xg, c_y, c_ctx = pair_row_context(face, cuv, lod, cube_base)
    cube_idx = ((c_layer * c_h + c_y) * c_wq
                + torch.div(c_xg, 4, rounding_mode="floor"))

    zero = torch.zeros(covered.shape, dtype=torch.int32, device=dev)
    s_layer, s_x, s_y, s_ctx = quad_row_context(zero, sky_uv, sky_base)
    sky_idx = cube_rows + ((s_layer * s_h + s_y) * s_wq
                           + torch.div(s_x, 4, rounding_mode="floor"))

    if bg_uv is None:
        bg_idx = sky_idx
        b_ctx = s_ctx
    else:
        b_layer, b_x, b_y, b_ctx = quad_row_context(zero, bg_uv, bg_base)
        bg_idx = cube_rows + sky_rows + (
            (b_layer * b_h + b_y) * b_wq
            + torch.div(b_x, 4, rounding_mode="floor"))

    idx = torch.where(covered, cube_idx, torch.where(use_sky, sky_idx,
                                                     bg_idx))
    row = env_table[idx.long()]  # THE one row fetch

    # Cube: select the pair block for base x % 4, then pair-filter.
    pair_block = quad_select(row, c_ctx["qj"], 52)  # 13 groups x 4 ch
    refl = pair_filter_row(pair_block, c_ctx, 4)

    sky_block = quad_select(row[..., :64], s_ctx["qj"], 16)
    sky_rgba = quad_filter_row(sky_block, s_ctx, 4)

    if bg_uv is None:
        bg_rgba = sky_rgba
    else:
        bg_block = quad_select(row[..., :64], b_ctx["qj"], 16)
        bg_rgba = quad_filter_row(bg_block, b_ctx, 4)
    return refl, sky_rgba, bg_rgba
