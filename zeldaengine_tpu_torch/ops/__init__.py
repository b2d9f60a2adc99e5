# rasterize_visibility / rasterize_depth: the brute-force raster, the
# frame's route under raster="jnp" and the yardstick of the pair raster.
from zeldaengine_tpu_torch.ops.rasterize import (
    TriangleSetup,
    triangle_setup,
    triangle_setup_plain,
    rasterize_visibility,
    rasterize_depth,
    interpolation_coeffs,
)
from zeldaengine_tpu_torch.ops.rasterize_cuda import (
    PairedTriangles,
    build_pairs,
    rasterize_pairs,
    rasterize_pairs_fused,
    rasterize_pairs_plain,
    rasterize_pairs_fused_plain,
)
from zeldaengine_tpu_torch.ops.shadow import (
    compute_shadow_coord,
    compute_pcf,
)
from zeldaengine_tpu_torch.ops.pcf_cuda import (
    compute_pcf_vmem,
    compute_pcf_plain,
)
from zeldaengine_tpu_torch.ops.window_tap import (
    sample_base_window,
    sample_base_window_plain,
)
from zeldaengine_tpu_torch.ops.lighting_cuda import (
    point_lighting,
    point_lighting_plain,
)
from zeldaengine_tpu_torch.ops.pcf_window import (
    compute_pcf_pallas,
    compute_pcf_pallas_plain,
)
from zeldaengine_tpu_torch.math.transforms import fma_f32
from zeldaengine_tpu_torch.ops.pcf_tables import (
    build_pcf_window_table,
    build_pcf_window_table_plain,
    build_pcf_window2d_table,
    build_pcf_window2d_table_plain,
)

# The hand-written kernels, by the name of their C entry point (minus the
# ``zk_`` prefix), with the wrapper that launches each. Every wrapper
# carries a plain integer ``launches`` that it raises by one where it
# launches its kernel, and nowhere else. The probe tools' kernels
# (``gather_probe``, ``fma_peak``) add themselves from their modules,
# which the end of this file imports.
KERNEL_WRAPPERS = {
    "pair_raster": rasterize_pairs,
    "pair_raster_fused": rasterize_pairs_fused,
    "pcf_taps": compute_pcf_vmem,
    "bilinear_tap": sample_base_window,
    "point_lights": point_lighting,
    "pcf_window": compute_pcf_pallas,
    "pcf_window_table": build_pcf_window_table,
    "pcf_window2d_table": build_pcf_window2d_table,
    "fma": fma_f32,
    "triangle_setup": triangle_setup,
}


def kernel_launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_kernel_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


# Imported last: each probe tool registers its kernel's wrapper above
# (a tool imported first finds this package complete and registers when
# its own module body ends).
import zeldaengine_tpu_torch.tools.gather_probe  # noqa: E402,F401
import zeldaengine_tpu_torch.tools.walk_stats  # noqa: E402,F401
