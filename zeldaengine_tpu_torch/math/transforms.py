"""GLM-compatible transform math (column-vector convention, numpy layout).

The reference engine uses glm with ``GLM_FORCE_DEPTH_ZERO_TO_ONE``
(ZeldaEngine.cpp:41-42), i.e. right-handed view space with Vulkan-style
[0, 1] clip depth. glm stores matrices column-major (``m[col][row]``); here
matrices are standard ``M[row, col]`` applied as ``M @ v`` to column
vectors, so ``M[r, c] == glm_m[c][r]``.

Parity sources (reference file:line):
- look_at           <- glm::lookAt used at ZeldaEngine.cpp:4650 (up=(0,0,1))
- perspective_vk    <- glm::perspective + proj[1][1] *= -1 (ZeldaEngine.cpp:4651, :4615)
- transform_matrix  <- XkTransfrom::GetMatrix (ZeldaEngine.cpp:398-406):
                       scale(I,S) * mat4_cast(Q) * translate(Location)
- make_rot_matrix   <- MakeRotMatrix (Shaders/Common.glsl:60-87), replicated
                       numerically including its axis-naming quirks
- euler_instance_matrix <- BaseInstanced.vert:69-75 instance placement

Inputs may be tensors, numpy arrays or Python sequences; results are
float32 tensors on the device of the first tensor argument (CPU when no
argument is a tensor). Matrix products are plain fp32 ``@`` (TF32 is
switched off at package import), but for the frame's camera and shadow
matrices (``look_at``, ``perspective``, ``mat4_product``), which round as
the JAX package's compiled ``passes/view.py::_view_matrices`` does on the
CPU: the frame's shadow and cull tests depend on their last bits.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch


def _t(x, like: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    dev = like.device if like is not None else None
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def matmul_f32(a, b):
    """Matrix multiply at full fp32 precision."""
    return torch.matmul(a, b)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 square root on every device (the fp64 root of
    an fp32 value rounds to the fp32 root exactly). PyTorch's vectorised
    fp32 ``sqrt`` on the CPU is off by one ulp on ~15 % of inputs."""
    return torch.sqrt(x.double()).float()


def dot3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_k x[..., k] * y[..., k] over a last axis of 3 as XLA's compiled
    dot products and sums of squares form it on the CPU: fma(x2, y2,
    fma(x1, y1, x0 * y0)). ``x`` and ``y`` broadcast together."""
    acc = x[..., 0] * y[..., 0]
    acc = fma_f32(x[..., 1], y[..., 1], acc)
    return fma_f32(x[..., 2], y[..., 2], acc)


def mat4_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(4, 4) @ (4, 4) as XLA's compiled product sums each entry on the
    CPU: fma(a3 b3, fma(a2 b2, fma(a1 b1, a0 b0))) over the inner index."""
    acc = a[:, 0:1] * b[0:1, :]
    for k in range(1, 4):
        acc = fma_f32(a[:, k:k + 1], b[k:k + 1, :], acc)
    return acc


def _cross_fused(a, b):
    """a x b with each component fma(a_i, b_j, -(a_j * b_i))."""
    i, j = [1, 2, 0], [2, 0, 1]
    return fma_f32(a[i], b[j], -(a[j] * b[i]))


def _normalize_fused(v):
    return v / sqrt_f32(torch.clamp_min(dot3(v, v), 1e-20))


def look_at(eye, center, up):
    """glm::lookAtRH. Returns 4x4 view matrix, rounded as the JAX package's
    compiled ``_view_matrices`` rounds it on the CPU: cross products and
    norms with fused multiply-adds, the rows' translations s.eye and f.eye
    summed without and u.eye with them (XLA fuses u's cross product into
    its dot product)."""
    eye = _t(eye)
    center = _t(center, eye)
    up = _t(up, eye)
    f = _normalize_fused(center - eye)
    s = _normalize_fused(_cross_fused(f, up))
    u = _cross_fused(s, f)

    def plain_dot(a, b):
        return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]

    return torch.stack(
        [
            torch.cat([s, -plain_dot(s, eye)[None]]),
            torch.cat([u, -dot3(u, eye)[None]]),
            torch.cat([-f, plain_dot(f, eye)[None]]),
            _t([0.0, 0.0, 0.0, 1.0], eye),
        ]
    )


def perspective(fovy_radians, aspect, z_near, z_far):
    """glm::perspectiveRH_ZO (GLM_FORCE_DEPTH_ZERO_TO_ONE): depth in [0,1].
    The tangent is correctly rounded and ``aspect`` an fp32 factor, as XLA
    folds them in the JAX package's compiled ``_view_matrices``."""
    tan_half = torch.tan((_t(fovy_radians) / 2.0).double()).float()
    zero = torch.zeros((), dtype=torch.float32, device=tan_half.device)
    one = torch.ones((), dtype=torch.float32, device=tan_half.device)
    m00 = 1.0 / (_t(aspect, tan_half) * tan_half)
    m11 = 1.0 / tan_half
    m22 = z_far / (z_near - z_far)
    m23 = -(z_far * z_near) / (z_far - z_near)
    return torch.stack(
        [
            torch.stack([m00, zero, zero, zero]),
            torch.stack([zero, m11, zero, zero]),
            torch.stack([zero, zero, m22 * one, m23 * one]),
            torch.stack([zero, zero, -one, zero]),
        ]
    )


def perspective_vk(fovy_radians, aspect, z_near, z_far):
    """perspective with the Vulkan Y flip the reference applies
    (``Proj[1][1] *= -1``, ZeldaEngine.cpp:4615/:4658)."""
    m = perspective(fovy_radians, aspect, z_near, z_far).clone()
    m[1, 1] = m[1, 1] * -1.0
    return m


@functools.lru_cache(maxsize=None)
def _libm_sincos():
    """The C library's scalar ``cosf`` and ``sinf``."""
    path = ctypes.util.find_library("m")
    if path is None:
        raise OSError("the C math library (libm) was not found")
    lib = ctypes.CDLL(path)
    for name in ("cosf", "sinf"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_float]
    return lib.cosf, lib.sinf


def rotate_z(angle):
    """glm::rotate(mat4(1), angle, (0,0,1)) - the stage-roll localToWorld
    (ZeldaEngine.cpp:4614), for one angle, as a (4, 4) float32 tensor on
    the CPU.

    The JAX package's compiled ``_view_matrices`` lowers its scalar
    ``cos`` / ``sin`` to calls of the C library's ``cosf`` / ``sinf``
    (the symbols in XLA's object code for the CPU), which are not
    correctly rounded; PyTorch's vectorised ones differ from them in the
    last bit on ~9 % of angles. The same two calls give the reference's
    matrix bit for bit."""
    a = float(np.float32(angle.item() if isinstance(angle, torch.Tensor)
                         else angle))
    cosf, sinf = _libm_sincos()
    c, s = np.float32(cosf(a)), np.float32(sinf(a))
    return torch.from_numpy(np.array(
        [[c, -s, 0.0, 0.0],
         [s, c, 0.0, 0.0],
         [0.0, 0.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 1.0]], np.float32))


def quat_to_mat4(q):
    """glm::mat4_cast for quaternion (w, x, y, z)."""
    q = _t(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    zero = torch.zeros_like(w)
    one = torch.ones_like(w)
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy), zero]),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx), zero]),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy), zero]),
            torch.stack([zero, zero, zero, one]),
        ]
    )


def scale_mat(s3):
    s3 = _t(s3)
    m = torch.eye(4, dtype=torch.float32, device=s3.device)
    m[0, 0], m[1, 1], m[2, 2] = s3[0], s3[1], s3[2]
    return m


def translate_mat(t3):
    t3 = _t(t3)
    m = torch.eye(4, dtype=torch.float32, device=t3.device)
    m[0, 3], m[1, 3], m[2, 3] = t3[0], t3[1], t3[2]
    return m


def transform_matrix(location, quaternion, scale3d):
    """XkTransfrom::GetMatrix (ZeldaEngine.cpp:398-406).

    glm composes: M = scale(I, S); M *= mat4_cast(Q); M = translate(M, Loc)
    which in column-vector math is ``S @ R @ T`` (translation applied first
    in object space - the reference's exact, slightly unusual, order).
    """
    location = _t(location)
    quaternion = _t(quaternion, location)
    scale3d = _t(scale3d, location)
    return matmul_f32(
        matmul_f32(scale_mat(scale3d), quat_to_mat4(quaternion)),
        translate_mat(location),
    )


def make_rot_matrix(r3):
    """Numerical replica of Common.glsl:60-87 MakeRotMatrix (3x3 part).

    The GLSL builds three matrices from (r.x, r.y, r.z) - despite the
    comments, mx rotates about +Y, my about +Z, mz about +X - and returns
    ``mz * my * mx``. GLSL ``m[i]`` is column i, so in row-major layout:

      mx = [[ c,0,-s],[0,1,0],[ s,0,c]]   (angle r.x)
      my = [[ c,-s,0],[ s,c,0],[0,0,1]]   (angle r.y)
      mz = [[1,0,0],[0, c,-s],[0, s,c]]   (angle r.z)
    """
    r3 = _t(r3)
    sx, cx = torch.sin(r3[..., 0]), torch.cos(r3[..., 0])
    sy, cy = torch.sin(r3[..., 1]), torch.cos(r3[..., 1])
    sz, cz = torch.sin(r3[..., 2]), torch.cos(r3[..., 2])
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    mx = torch.stack(
        [
            torch.stack([cx, zero, -sx], -1),
            torch.stack([zero, one, zero], -1),
            torch.stack([sx, zero, cx], -1),
        ],
        -2,
    )
    my = torch.stack(
        [
            torch.stack([cy, -sy, zero], -1),
            torch.stack([sy, cy, zero], -1),
            torch.stack([zero, zero, one], -1),
        ],
        -2,
    )
    mz = torch.stack(
        [
            torch.stack([one, zero, zero], -1),
            torch.stack([zero, cz, -sz], -1),
            torch.stack([zero, sz, cz], -1),
        ],
        -2,
    )
    return matmul_f32(matmul_f32(mz, my), mx)


def euler_instance_matrix(rotation3):
    """The 3x3 used by BaseInstanced.vert:69-71.

    GLSL does ``position * mat3(rotMat)`` - a row-vector multiply, i.e.
    rotMat^T applied to a column vector. This returns the matrix R such that
    ``R @ p`` reproduces ``p * mat3(MakeRotMatrix(rotation))``.
    """
    return torch.swapaxes(make_rot_matrix(rotation3), -1, -2)


def fma_f32(a: torch.Tensor, b, c, backend: str = "auto") -> torch.Tensor:
    """fp32 ``a * b + c`` with ONE rounding (a fused multiply-add), the
    operands broadcast together; ``b`` and ``c`` may be Python numbers
    (fp32 constants). Tensors on the card go to kernel ``fma``
    (``csrc/fma.cu``, ``__fmaf_rn``) in one launch; CPU tensors (or
    ``backend="torch"``) to ``fma_f32_plain``."""
    from zeldaengine_tpu_torch.ops import _build
    from zeldaengine_tpu_torch.ops.rasterize_cuda import _use_kernel

    if not _use_kernel(a, backend):
        return fma_f32_plain(a, b, c)
    dev = a.device
    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    for x in tensors:
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"fma_f32: expected float32 tensors on {dev}, "
                             f"got {x.dtype} on {x.device}")
    views = iter(torch.broadcast_tensors(*tensors))  # stride 0: broadcast
    ops = [next(views) if isinstance(x, torch.Tensor) else float(x)
           for x in (a, b, c)]
    shape = ops[0].shape
    if len(shape) > 6:
        raise ValueError(f"fma_f32: at most 6 dimensions, got {len(shape)}")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    meta = list(shape)
    for x in ops:  # strides in elements
        meta += (list(x.stride()) if isinstance(x, torch.Tensor)
                 else [0] * len(shape))
    meta = (ctypes.c_longlong * max(1, len(meta)))(*meta)
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else None
            for x in ops]
    vals = [0.0 if isinstance(x, torch.Tensor) else x for x in ops]
    with torch.cuda.device(dev):
        code = _build.load().zk_fma(
            *ptrs, *vals, out.data_ptr(), out.numel(), len(shape), meta,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "fma")
    _FMA_WRAPPER.launches += 1
    return out


fma_f32.launches = 0
# The count lives on the wrapper but is raised under this name: this
# module's own callers reach ``fma_f32`` through its global name, which a
# caller may patch to note the calls.
_FMA_WRAPPER = fma_f32


# The 29 low mantissa bits fp64 has beyond fp32's, and their value at an
# fp32 tie (half an fp32 ulp).
_F32_DROPPED = (1 << 29) - 1
_F32_TIE = 1 << 28


def fma_f32_plain(a: torch.Tensor, b, c) -> torch.Tensor:
    """Plain PyTorch version of ``fma_f32`` (any device). The fp32 product
    is exact in fp64, and the fp64 sum cast to fp32 rounds once, correctly,
    but where the sum sits exactly on an fp32 tie (fp32 ties are fp64
    numbers, so rounding to fp64 cannot carry a sum across one) or outside
    fp32's normal range. There the sum is rounded to odd (its error
    recovered by TwoSum and folded into the last bit) before the cast: no
    double rounding."""
    def f64(x):  # Python numbers become fp32 constants first
        return torch.as_tensor(x, dtype=torch.float32,
                               device=a.device).double()

    p = f64(a) * f64(b)
    c = f64(c)
    s = p + c
    out = s.float()
    mag = s.abs()
    redo = (((s.view(torch.int64) & _F32_DROPPED) == _F32_TIE)
            | (mag < 2.0 ** -126) | ~(mag < 2.0 ** 127))
    if bool(redo.any()):
        idx = redo.reshape(-1).nonzero().squeeze(1)

        def at(x):
            return x.expand(s.shape).reshape(-1)[idx]

        pr, cr, sr = at(p), at(c), at(s)
        bb = sr - pr
        err = (pr - (sr - bb)) + (cr - bb)
        even = (sr.view(torch.int64) & 1) == 0
        odd = torch.nextafter(sr, torch.copysign(
            torch.full_like(sr, math.inf), err))
        out.view(-1)[idx] = torch.where(
            (err != 0) & even & torch.isfinite(sr), odd, sr).float()
    return out


def apply_mat4_point(m, p):
    """(..., 4, 4) @ point (..., 3) with w=1 -> (..., 3) (no divide), as
    the JAX package's compiled frame sums it on the CPU:
    fma(p2, m2, fma(p0, m0, p1 * m1)) + m3."""
    return _mat4_sum(m[..., :3, :], p)


def apply_mat4_h(m, p):
    """(4,4) @ (..., 3, ) point with w=1 -> homogeneous (..., 4), summed
    as ``apply_mat4_point``."""
    return _mat4_sum(m, p)


def _mat4_sum(m, p):
    t = fma_f32(p[..., 0, None], m[..., :, 0], p[..., 1, None] * m[..., :, 1])
    return fma_f32(p[..., 2, None], m[..., :, 2], t) + m[..., :, 3]
