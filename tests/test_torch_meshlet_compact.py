"""Live-triangle compaction of the meshlet path (``compact_setup``,
``remap_pair_tri``) against the JAX package's, bit for bit at caps below,
equal to and above the live count."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops import rasterize_pallas as j_rp
from zeldaengine_tpu.ops.rasterize import TriangleSetup as JSetup
from zeldaengine_tpu_torch.ops import rasterize_cuda as rc
from zeldaengine_tpu_torch.ops.rasterize import TriangleSetup

torch.set_num_threads(1)


def _random_setup(seed=0, t=600):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, 100.0, t).astype(np.float32)
    y0 = rng.uniform(0.0, 100.0, t).astype(np.float32)
    return dict(
        edge=rng.normal(size=(t, 3, 3)).astype(np.float32),
        zc=rng.normal(size=(t, 3)).astype(np.float32),
        valid=rng.random(t) < 0.7,
        # Widths from -0.5 (dead) to 3 px, many with no pixel centre.
        bbox=np.stack([x0, y0, x0 + rng.uniform(-0.5, 3.0, t),
                       y0 + rng.uniform(-0.5, 3.0, t)], 1).astype(np.float32),
        zmin=rng.random(t).astype(np.float32))


@pytest.mark.parametrize("center_cull", [False, True])
@pytest.mark.parametrize("cap", ["below", "equal", "above"])
def test_compact_setup_and_remap_match_the_reference(cap, center_cull):
    """Bit for bit at caps below, equal to and above the live count: the
    compacted rows (dead padding rows zeros, id T), the extra payload, the
    original ids, the overflow (highest live ids dropped first), and
    pair_tri remapped to original ids with dead pairs -> T."""
    a = _random_setup()
    t = a["edge"].shape[0]
    extra = np.random.default_rng(1).normal(size=(t, 7)).astype(np.float32)
    js = JSetup(**{k: jnp.asarray(v) for k, v in a.items()})
    ts = TriangleSetup(**{k: torch.from_numpy(v) for k, v in a.items()})
    n_live = int(np.asarray(j_rp.compact_setup(js, t, center_cull=center_cull)
                            [2] < t).sum())
    n = {"below": n_live // 2, "equal": n_live, "above": n_live + 50}[cap]
    want = j_rp.compact_setup(js, n, extra=jnp.asarray(extra),
                              center_cull=center_cull)
    got = rc.compact_setup(ts, n, extra=torch.from_numpy(extra),
                           center_cull=center_cull)
    for name, w, g in zip(JSetup._fields, want[0], got[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for name, w, g in zip(("extra", "idx"), want[1:3], got[1:3]):
        assert g.dtype == torch.float32 if name == "extra" else torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[3]) == int(want[3]) == max(n_live - n, 0)
    # The pairs of the compacted setup, their ids remapped.
    pairs = rc.build_pairs(got[0], 128, 128, 8, 32, expand=4,
                           sort_z=True, ysort_sub_rows=8,
                           center_cull=center_cull)
    assert int((pairs.pair_tri == n).sum()) > 0  # dead pairs present
    remapped = rc.remap_pair_tri(pairs, got[2], t)
    jpairs = collections.namedtuple("Pairs", "pair_tri")(
        jnp.asarray(pairs.pair_tri.numpy()))
    np.testing.assert_array_equal(
        remapped.pair_tri.numpy(),
        np.asarray(j_rp.remap_pair_tri(jpairs, want[2], t).pair_tri))
    assert remapped.pair_tri.dtype == torch.int32
