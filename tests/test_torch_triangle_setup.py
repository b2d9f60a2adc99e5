"""Kernel ``triangle_setup``'s plain version on the setup's edge cases
against the JAX package's jitted setup, the wrapper's dispatch, and kernel
``fma``'s host-side layout: the elements its index math addresses
(simulated with NumPy; the kernels themselves run only on the card, where
chip_smoke.py holds them against their plain versions)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeldaengine_tpu.ops import rasterize as jr
from zeldaengine_tpu_torch.math import transforms as tt
from zeldaengine_tpu_torch.ops import rasterize as tr

from _torch_setup_cases import (
    HEIGHT, WIDTH, setup_edge_clips, two_sided_modes, valid_mask)

torch.set_num_threads(1)

FIELDS = ("edge", "zc", "valid", "bbox", "zmin")


def _same(a, b):
    """Bit for bit (a zero's sign counts); two NaNs are equal whatever
    their bits (XLA and PyTorch give NaNs other signs)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != np.float32:
        return a == b
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a)
                                                       & np.isnan(b))


@pytest.mark.parametrize("depth_bias", [None, (1.25, 7.5)])
def test_edge_cases_match_jax(depth_bias):
    """Zero-area and degenerate triangles, all w <= 0, w straddling
    +-1e-6, |det_scaled| near 1e-20, padded zero rows, very large
    coordinates and depths of +-0.0; two_sided as a bool and as a mask,
    with and without a valid mask. XLA's CPU code flushes subnormal
    results to zero, and the |det_scaled| case has subnormal minors: the
    plain version runs with subnormals flushed too (on the card neither
    the kernel nor its plain version flushes)."""
    cases = setup_edge_clips()
    clip = np.concatenate(list(cases.values()))
    names = np.repeat(list(cases), [len(c) for c in cases.values()])
    n = clip.shape[0]
    for mode, two in two_sided_modes(n).items():
        vm = None if mode == "false" else valid_mask(n)
        js = jax.jit(lambda c, t, v: jr.triangle_setup(
            c, WIDTH, HEIGHT, two_sided=t, valid_mask=v,
            depth_bias=depth_bias))(
            jnp.asarray(clip), jnp.asarray(two),
            None if vm is None else jnp.asarray(vm))
        assert torch.set_flush_denormal(True)
        try:
            ts = tr.triangle_setup_plain(
                torch.from_numpy(clip), WIDTH, HEIGHT,
                two_sided=torch.from_numpy(two) if mode == "mask" else two,
                valid_mask=None if vm is None else torch.from_numpy(vm),
                depth_bias=depth_bias)
        finally:
            torch.set_flush_denormal(False)
        for name in FIELDS:
            same = _same(getattr(ts, name).numpy(), getattr(js, name))
            same = same.reshape(n, -1).all(1)
            assert same.all(), (mode, name, sorted(set(names[~same])))
    # Every case reaches both sides of the tests it was made for.
    assert 0 < int(ts.valid.sum()) < n
    assert bool((ts.zmin == 0).any()) and not bool(
        torch.signbit(ts.zmin).any())


def test_wrapper_sends_cpu_tensors_to_the_plain_version():
    clip = torch.from_numpy(setup_edge_clips(n=64)["degenerate"])
    two = torch.from_numpy(two_sided_modes(64)["mask"])
    tr.triangle_setup.launches = 0
    got = tr.triangle_setup(clip, WIDTH, HEIGHT, two_sided=two,
                            depth_bias=(1.25, 7.5))
    want = tr.triangle_setup_plain(clip, WIDTH, HEIGHT, two_sided=two,
                                   depth_bias=(1.25, 7.5))
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert tr.triangle_setup.launches == 0
    with pytest.raises(RuntimeError, match="card"):
        tr.triangle_setup(clip, WIDTH, HEIGHT, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tr.triangle_setup(clip, WIDTH, HEIGHT, backend="jax")


def _kernel_offsets(shape, strides):
    """Each operand's element offsets (or None for a value) in the order
    kernel ``fma`` writes its outputs: a thread takes 4 neighbouring
    outputs, divides the first one's index by the inner sizes with the
    multiply-shift constants and steps the coordinates on from there."""
    sizes, modes, st = tt.fma_layout(shape, strides)
    n = math.prod(shape)
    (m1, s1), (m2, s2) = tt.fast_div(sizes[1]), tt.fast_div(sizes[2])

    def div(x, m, s):
        return x if m == 0 else (x * m >> 32) >> s

    base = np.arange(0, n, 4, dtype=np.int64)
    q = div(base, m2, s2)
    c2 = base - q * sizes[2]
    c0 = div(q, m1, s1)
    c1 = q - c0 * sizes[1]
    offs = np.zeros((3, base.size, 4), np.int64)
    for e in range(4):
        for k in range(3):
            offs[k, :, e] = c0 * st[k][0] + c1 * st[k][1] + c2 * st[k][2]
        c2 = c2 + 1
        wrap = c2 == sizes[2]
        c2[wrap] = 0
        c1 = c1 + wrap
        wrap = c1 == sizes[1]
        c1[wrap] = 0
        c0 = c0 + wrap
    flat = (base[:, None] + np.arange(4)).reshape(-1)[:n]
    return [None if m == tt.FMA_VALUE
            else flat if m == tt.FMA_FLAT
            else offs[k].reshape(-1)[:n]
            for k, m in enumerate(modes)]


def _layouts():
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    p, m = t(1001, 3), t(4, 4)
    grid = t(40, 100)
    frame_t = p[..., 1, None] * m[:3, 1]
    return {
        # _mat4_sum: (N, 1) x (3,) + (N, 3), and the clip transform's (4,)
        "position transform": (p[..., 0, None], m[:3, 0], frame_t),
        "clip transform": (p[..., 2, None], m[:, 2],
                           p[..., 1, None] * m[:, 1]),
        "mat4_product": (m[:, 1:2], m[1:2, :], m[:, 0:1] * m[0:1, :]),
        "dot3 over rows": (t(997, 3)[:, 1], t(3)[1], t(997)),
        "flat, tail of 3": (t(1003), t(1003), t(1003)),
        "unaligned flat views": (t(1004)[1:], t(1005)[2:], t(1006)[3:]),
        "strided views, scalar": (grid[:, ::3], 7.5, grid.t()[::3].t()),
        "broadcast scalars": (grid[:, :1], t(100), 0.1),
        "0-d tensors": (t(5, 7), torch.tensor(2.0), torch.tensor(-1.0)),
        "stride-0 middle dim": (t(5, 1, 7), t(1, 6, 1), t(5, 6, 7)),
        "3 dims": (t(6, 5, 7)[:, ::2], t(6, 1, 7), t(1, 3, 1)),
        "one element": (t(1), 3.0, t(1, 1)),
    }


def test_fma_layout_addresses_the_broadcast_elements():
    """The collapsed layout and the kernel's 32-bit index math address
    exactly the elements ``torch.broadcast_tensors`` gives, for the
    frame's layouts and broadcast, strided, unaligned, scalar and
    stride-0 ones; the frame's (N, 1) x (3,) + (N, 3) transform keeps its
    (N, 3) output flat."""
    for name, ops in _layouts().items():
        tensors = [x for x in ops if isinstance(x, torch.Tensor)]
        views = iter(torch.broadcast_tensors(*tensors))
        bops = [next(views) if isinstance(x, torch.Tensor) else x
                for x in ops]
        shape = bops[0].shape
        offsets = _kernel_offsets(
            shape, [x.stride() if isinstance(x, torch.Tensor) else None
                    for x in bops])
        for k, (x, off) in enumerate(zip(bops, offsets)):
            if off is None:
                assert not isinstance(x, torch.Tensor), name
                continue
            storage = torch.as_strided(
                x, (x.untyped_storage().nbytes() // 4,), (1,), 0)
            got = storage[x.storage_offset() + torch.from_numpy(off)]
            assert torch.equal(got, x.reshape(-1)), (name, k)
    sizes, modes, _ = tt.fma_layout((1001, 3), [(3, 0), (0, 4), (3, 1)])
    assert sizes == [1, 1001, 3] and modes == [tt.FMA_STRIDED,
                                               tt.FMA_STRIDED, tt.FMA_FLAT]
    assert tt.fma_layout((8, 9), [(9, 1)] * 3)[0] == [1, 1, 72]
    with pytest.raises(ValueError, match="at most 3"):
        tt.fma_layout((2, 3, 4, 5), [(60, 0, 5, 1), (0, 20, 0, 1), None])


def test_fast_div_matches_integer_division():
    """Kernel ``fma``'s multiply-shift division equals ``n // d`` for the
    sizes of the frame's layouts and others, at every n near multiples of
    d and at the ends of the 31-bit range."""
    rng = np.random.default_rng(1)
    divisors = list(range(1, 1025)) + [1001, 14004, 164624, 329248,
                                       (1 << 20) + 1, (1 << 30) - 1, 1 << 30]
    top = (1 << 31) - 1
    for d in divisors:
        m, s = tt.fast_div(d)
        assert 0 <= m < 1 << 32
        k = rng.integers(0, top // d + 1, 2000, dtype=np.int64)
        n = np.concatenate([k * d - 1, k * d, k * d + d - 1,
                            np.arange(min(4 * d, 1 << 14)), [top, top - 1]])
        n = n[(n >= 0) & (n <= top)]
        q = n if m == 0 else (n * m >> 32) >> s
        assert np.array_equal(q, n // d), d
