"""Engine configuration: the fields and defaults of the port's
``EngineConfig`` (frozen from ``zeldaengine_tpu_torch/config.py`` at
commit fcd25b5), so that a configuration file's settings read here as the
engine reads them and a key it does not know is refused.

The reference engine's compile-time ``#define`` block
(ZeldaEngine.cpp:77-98: VIEWPORT 1920x1080, MAX_FRAMES_IN_FLIGHT 2,
PBR_SAMPLER_NUMBER 7, MAX_DIRECTIONAL_LIGHTS_NUM 16 / POINT 512 / SPOT 16,
SHADOWMAP_DIM 1024, feature gates) maps to a frozen dataclass. Most fields
pick the engine's implementation (tiles, caps, kernels) and change nothing
that the reference renders; ``reference/render.py`` refuses the settings
whose frames it does not render.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Viewport (ZeldaEngine.cpp:78-79)
    width: int = 1920
    height: int = 1080

    # MAX_FRAMES_IN_FLIGHT (ZeldaEngine.cpp:77): with 2, Engine.tick
    # returns the PREVIOUS frame while the current one renders (one frame
    # of latency, the reference's swapchain pipelining). 1 = synchronous
    # present.
    frames_in_flight: int = 2
    # Present mode (the swapchain mode choice, ZeldaEngine.cpp:6589-6599:
    # VK_PRESENT_MODE_MAILBOX_KHR preferred, FIFO fallback).
    #   "mailbox": tick never blocks on the device->host frame fetch; a
    #     full present queue replaces its stalest pending frame with the
    #     newest, and tick returns the newest COMPLETED frame.
    #   "fifo": tick waits for a completed frame (staleness bounded by
    #     frames_in_flight) - deterministic, used by tests.
    present_mode: str = "mailbox"

    # Shadow map (ZeldaEngine.cpp:87) and PCF kernel radius (Base.frag:67)
    shadowmap_dim: int = 1024
    pcf_radius: int = 2
    pcf_scale: float = 1.5  # texel scale inside ComputePCF (Common.glsl:326)
    # Shadow depth bias, applied at shadow rasterization exactly like the
    # reference's vkCmdSetDepthBias(1.25, 0, 7.5) (:3280-3287): written
    # depth += slope * max|dz/dpixel| + constant * 2^-23. ``shadow_bias``
    # is an extra compare-time constant (default off).
    shadow_bias_constant: float = 1.25
    shadow_bias_slope: float = 7.5
    shadow_bias: float = 0.0
    # Radius of the procedural skydome sphere (the reference's skydome.obj
    # has a fixed modeled radius); must be < camera zFar to survive clip.
    skydome_radius: float = 30.0
    # "analytic": closed-form ray/sphere dome (exact infinite-tessellation
    # limit, no raster, one tap). "mesh": rasterize the dome mesh like the
    # reference (kept for parity testing).
    skydome_mode: str = "analytic"

    # Light capacities (ZeldaEngine.cpp:84-86)
    max_directional_lights: int = 16
    max_point_lights: int = 512
    max_spot_lights: int = 16

    # PBR material texture slots (ZeldaEngine.cpp:80):
    # basecolor, metallic, roughness, normal, AO, emissive, mask
    pbr_sampler_number: int = 7

    # Scene pool capacities (static shapes, the analogue of the
    # reference's MAX_* constants). Scenes are padded up to these.
    max_vertices: int = 1 << 16
    max_triangles: int = 1 << 16
    max_instances: int = 1 << 12
    max_materials: int = 64

    # Texture pool: every 2D texture is resampled to this square size and
    # stacked into one array ("bindless" indexing; ZeldaEngine.cpp:96 TODO).
    texture_size: int = 256
    # Cubemap face size; mip count derives from it.
    cubemap_size: int = 256
    background_size: int = 512

    # Rasterizer tiling: one thread block of the pair rasterizer owns one
    # tile_h x tile_w screen tile.
    tile_h: int = 32
    tile_w: int = 128
    # Shadow-pass tile shape override (None = same as tile_h/tile_w):
    # the light-space geometry distribution differs from screen space,
    # so the best shape can differ.
    shadow_tile_h: int | None = None
    shadow_tile_w: int | None = None
    tri_chunk: int = 128
    # Exact-pair binning: triangles whose bbox covers more than this many
    # tiles spill to supertile pairs, then to a global bucket walked by
    # every tile.
    pair_expand: int = 8
    # Shadow-pass expand (light-space tiles at shadowmap resolution are
    # coarse; prep cost scales with T*expand while the supertile level
    # absorbs the spill, so a smaller budget wins).
    pair_expand_shadow: int = 4
    # Live-pair capacity: dead/culled pairs sort last, so slicing the
    # sorted stream to this many pairs makes the O(P) record gather
    # track the POST-CULL visible count instead of T * pair_expand
    # capacity. None = uncapped (exact). Live pairs beyond the cap are
    # dropped deterministically and counted (``aux["pair_overflow"]``).
    max_pairs: int | None = None
    max_pairs_shadow: int | None = None
    # Live-triangle compaction: when set, live (post-cull, on-screen)
    # triangles are compacted into this many slots BEFORE pair expansion.
    compact_tris: int | None = None
    # Shadow-pass compaction capacity. The SHADOW caster set is NOT the
    # camera-culled set (geometry behind the camera still casts), so it
    # must not inherit ``compact_tris``. None = no shadow compaction.
    compact_tris_shadow: int | None = None
    # Light-apex backface-cone cull of meshlets for the SHADOW pass.
    # Exact only for closed (watertight) meshes.
    shadow_cone_cull: bool = False
    # Slice-aligned pair bins: every bin starts at a 128-pair boundary.
    # Exact (pad positions hold the never-record). Off by default.
    pair_align: bool = False
    # Chunked / packed pair record gather (build_pairs gather_chunks /
    # gather_pack): layouts of the record gather that only matter to the
    # JAX package's schedule. Exact for any value; this package accepts
    # and ignores them.
    pair_gather_chunks: int = 1
    pair_gather_pack: int = 1
    # Exact sub-pixel cull: triangles whose bbox straddles no pixel
    # center rasterize nothing and are culled before pair binning.
    subpixel_cull: bool = False
    # "auto": CUDA kernels for tensors on the card, plain PyTorch for CPU
    # tensors. "cuda": the kernels (raises for CPU tensors). "torch": the
    # plain PyTorch versions on whatever device the tensors are on. The
    # JAX package's values pick the raster route, the kernels as "auto":
    # "fused" the fused kernel's planes (the "auto" route), "pallas" the
    # pair kernel with ids + the gather path, "jnp" the brute-force raster
    # + the gather path (passes/frame.py::raster_route).
    raster: str = "auto"
    sub_rows: int = 8
    # Front-to-back pair ordering (build_pairs sort_z). Only exact-depth
    # ties between different triangles can change winner.
    raster_zsort: bool = True
    # Y-bucketed pair bins: each bin's pairs are ordered by first covered
    # sub-block row (z within) and each record carries the triangle's
    # packed sub-block span. Exact (coverage outside the binning bbox is
    # empty).
    raster_ysort: bool = True
    # Occlusion early-out in the pair walks (needs raster_zsort): every
    # ``early_out_stride`` chunks a tile stops a range once every pixel
    # lies below the range's next z bucket. Automatically disabled while
    # ``raster_ysort`` is active: y-bucketed bins break the z monotonicity
    # the stop test needs. Not exact on thin triangles, whose computed
    # depth can lie below their vertices' (ROADMAP.md C).
    raster_early_out: bool = False
    early_out_stride: int = 4
    # Reflection IBL tap at half resolution + bilinear upsample. Off by
    # default: changes output (not bit-exact to the full-res tap).
    reflection_half: bool = False
    # PCF backend: "auto"/"vmem" = the 25-tap kernel (exact tap-for-tap
    # everywhere); "exact" = the plain 25-gather version on any device;
    # "packed"/"packed_b" = plain row-table filters and "packed_roll"/
    # "window_roll" = the same over kernel-built window tables (all
    # exact); "half"/"half_nearest"/"half_wr" = half resolution + 2x
    # upsample (one tap quantum off along penumbra edges); "pallas" = the
    # windowed kernel (taps clamp to a per-tile window: approximate);
    # "packed_y4"/"packed_y8" (shadow rows packed 4 or 8 a table row),
    # "packed4/8/16" (x bases fused 4-16 a row) and "window1" (one 2-D
    # window row a pixel) = plain exact filters without a kernel, and
    # "half_y4" = "half" over "packed_y4". Any other name raises.
    pcf_backend: str = "auto"
    pcf_window: int = 256  # windowed-backend shadow window (texels)
    # "vmem" backend window rows / unfit-block recompute cap of the JAX
    # package's kernel. The CUDA kernel taps the map directly and needs
    # neither; kept so configurations carry across.
    pcf_vmem_rows: int = 48
    pcf_fallback_cap: int = 64

    # Wireframe debug mode (ENABLE_WIREFRAME, ZeldaEngine.cpp:90 /
    # polygonMode LINE :5108-5110): only pixels within this barycentric
    # distance of a triangle edge stay covered.
    wireframe: bool = False
    wireframe_threshold: float = 0.02

    # Rendering toggles (reference gates ENABLE_DEFERRED_SHADING etc.)
    enable_deferred: bool = True
    enable_shadow: bool = True
    enable_skydome: bool = True
    enable_background: bool = False

    # Tiled light culling (the deferred analogue of Forward+): when the
    # point-light capacity exceeds the unroll limit, lights are binned to
    # screen tiles and each pixel shades at most max_tile_lights. Tile
    # dims must divide the frame (8 x 128 divides 1080 x 1920).
    max_tile_lights: int = 32
    light_tile_h: int = 8
    light_tile_w: int = 128
    # Engage tiled culling at this point-light TABLE CAPACITY.
    tiled_lights_min: int = 65
    # Point-light evaluation backend. "pallas"/"auto": lights culled to
    # (point_block_h x 128) tiles and shaded by the point-light kernel once
    # the table holds >= point_kernel_min slots and the width is a
    # multiple of 128. The JAX package's "auto" does so on an accelerator
    # only; the port's device is the card, so "auto" does so on every
    # device (CPU tensors take the kernel's plain version). "unroll": the
    # plain loop over the light table, or the plain tiled loop once the
    # table holds >= tiled_lights_min slots.
    point_light_kernel: str = "auto"
    point_block_h: int = 40
    point_kernel_min: int = 4

    # Merged environment tap: cubemap reflection + sky + background in
    # ONE fetch per pixel instead of separate taps.
    env_merge: bool = False
    # Low-tier cubemap reflection: serve lods >= 1 from a half-res RGB
    # mip-pair cube. Exact: level k of the half-res chain IS level k+1 of
    # the full chain.
    cube_low_tier: bool = True

    # Pad light tables to next_pow2(count) instead of the full capacity
    # (the unrolled light loop costs per capacity SLOT; see view.py).
    adaptive_light_capacity: bool = True

    # Validation mode (the VK_LAYER_KHRONOS_validation analogue,
    # ZeldaEngine.cpp:799-829): per-frame NaN/inf + silent-drop counters.
    validation: bool = False

    # zFar sentinel for empty depth buffer
    depth_clear: float = 1.0

    # DIAGNOSTIC ablations for in-context cost attribution (never correct
    # output): comma-separated set of {"nopcf", "nolight", "notex",
    # "noswitch", "nosky"}.
    ablate: str = ""
