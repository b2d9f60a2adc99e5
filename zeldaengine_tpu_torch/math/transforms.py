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
switched off at package import).
"""

from __future__ import annotations

import ctypes
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


def _normalize(v, dim=-1, eps=1e-20):
    return v / torch.sqrt(
        torch.clamp_min(torch.sum(v * v, dim=dim, keepdim=True), eps))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def look_at(eye, center, up):
    """glm::lookAtRH. Returns 4x4 view matrix."""
    eye = _t(eye)
    center = _t(center, eye)
    up = _t(up, eye)
    f = _normalize(center - eye)
    s = _normalize(_cross(f, up))
    u = _cross(s, f)
    return torch.stack(
        [
            torch.cat([s, -torch.dot(s, eye)[None]]),
            torch.cat([u, -torch.dot(u, eye)[None]]),
            torch.cat([-f, torch.dot(f, eye)[None]]),
            _t([0.0, 0.0, 0.0, 1.0], eye),
        ]
    )


def perspective(fovy_radians, aspect, z_near, z_far):
    """glm::perspectiveRH_ZO (GLM_FORCE_DEPTH_ZERO_TO_ONE): depth in [0,1]."""
    tan_half = torch.tan(_t(fovy_radians) / 2.0)
    zero = torch.zeros((), dtype=torch.float32, device=tan_half.device)
    one = torch.ones((), dtype=torch.float32, device=tan_half.device)
    m00 = 1.0 / (aspect * tan_half)
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


def rotate_z(angle):
    """glm::rotate(mat4(1), angle, (0,0,1)) - the stage-roll localToWorld
    (ZeldaEngine.cpp:4614)."""
    angle = _t(angle)
    c = torch.cos(angle)
    s = torch.sin(angle)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zero, zero]),
            torch.stack([s, c, zero, zero]),
            torch.stack([zero, zero, one, zero]),
            torch.stack([zero, zero, zero, one]),
        ]
    )


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


def fma_f32_plain(a: torch.Tensor, b, c) -> torch.Tensor:
    """Plain PyTorch version of ``fma_f32`` (any device). The fp32 product
    is exact in fp64; the fp64 sum is rounded to odd (its error recovered
    by TwoSum and folded into the last bit), so the final cast to fp32
    rounds once, correctly: no double rounding."""
    def f64(x):  # Python numbers become fp32 constants first
        return torch.as_tensor(x, dtype=torch.float32,
                               device=a.device).double()

    p = f64(a) * f64(b)
    c = f64(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf),
                                            err))
    s = torch.where((err != 0) & even & torch.isfinite(s), odd, s)
    return s.float()


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
