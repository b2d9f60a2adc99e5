"""Layer kernels: kernel ``pair_raster`` (K1, the shadow map, with the
merge of split tiles) against its roofline, over the traced frames the run
counts (``_roofline.py``), in percent."""

from frame_bench.metrics import _roofline


def read(run):
    return _roofline.share_pct(run, "shadow")
