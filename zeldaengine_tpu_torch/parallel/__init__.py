from zeldaengine_tpu_torch.parallel.tiles import (
    TileMesh,
    band_compact_config,
    band_pair_stats,
    jit_sharded_renderer,
    make_tile_mesh,
    render_frame_sharded,
    stripe_layout,
    unstripe_perm,
)

__all__ = [
    "TileMesh",
    "band_compact_config",
    "band_pair_stats",
    "jit_sharded_renderer",
    "make_tile_mesh",
    "render_frame_sharded",
    "stripe_layout",
    "unstripe_perm",
]
