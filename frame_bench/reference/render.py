"""The benchmark's plain reference: the frame the engine should show for a
world, a configuration and a camera, written straight from the engine's
semantics in float64 PyTorch.

``Reference(cfg)`` stages the configuration's world (or sphere grid) from
its own loaders (``loaders/``); ``render(camera)`` renders one frame:

1. view: the camera's look-at and Vulkan perspective (y flipped, depth in
   [0, 1]); the shadow view from directional light 0 towards the origin
   with the camera's field of view at aspect 1; the point lights on the
   viewer's ring (``UpdateUniformBuffer``);
2. the shadow map: every caster, two-sided, with the depth bias, by the
   brute-force raster of ``raster.py``;
3. the GBuffer: the deferred triangles (one-sided unless flagged two-sided)
   by the same raster, with ids; at each covered pixel the perspective-
   correct interpolants (uv, world position, world normal) and their
   analytic screen derivatives; the shading normal by the screen-space TBN
   of the default normal map (0.5, 0.5, 1), stored at 10 bits; the default
   material (grey base colour, metallic 0, roughness 1, AO 1, mask 1)
   stored at 8 bits;
4. the resolve: a 25-tap PCF of the shadow map (nearest texels at 1.5
   texels' spacing, wrapped, 0.1 where occluded), the default-lit BxDF
   (GGX, height-correlated Smith, Disney diffuse) of each directional light
   (times the PCF factor) and point light (linear falloff), the ambient
   term, gamma 0.4545; the reflection term is zero: no asset root is
   mounted, so the engine's cube map is its black default;
5. the analytic sky dome (radius ``skydome_radius`` about the origin) where
   the dome lies nearer than the GBuffer's depth, its texel the engine's
   default 0.25; clamped to [0, 1]; the presented frame is its uint8
   quantisation.

No tiles, pair lists, bins, caps or meshlets: a meshlet scene renders as
its plain meshes. Both raster passes come with the range each buffer
element may take under float32 rounding (``raster.bounds``); where the
configuration states the light-apex cone cull of the shadow casters
(whose result depends on how the program baked its meshlets), a texel's
range runs from every caster's to the light-facing casters'. The resolve
takes the map handed in (``render``).

``render(..., control="raster")`` is the same reference with its raster
computed in bfloat16 (vertices, setup, edge values and depths rounded to
bfloat16 as they are formed), ``control="vertex"`` with only its
clip-space vertices rounded: the comparison has to refuse both.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np
import torch

from frame_bench.reference import raster
from frame_bench.reference.loaders.config import EngineConfig
from frame_bench.reference.loaders.mesh import make_sphere
from frame_bench.reference.loaders.prefabs import stage, world_parts
from frame_bench.reference.loaders.world import World

F64 = torch.float64
PI = 3.14159265359
# The default material's textures (``scenebuild.default_slot_images``):
# the 0.5 sRGB grey base colour decoded to linear, metallic 0, roughness
# 1, AO 1, mask 1, and the flat normal-map value.
GREY_LINEAR = ((0.5 + 0.055) / 1.055) ** 2.4
TEX_NORMAL = (0.5, 0.5, 1.0)
# The engine's default sky image (no skydome texture mounted).
SKY_TEXEL = 0.25
SHADOW_OCCLUDED = 0.1
GAMMA = 0.4545


def quantize_u8(color: torch.Tensor) -> torch.Tensor:
    """The swapchain's uint8 quantisation (the engine's present)."""
    return torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)


def sphere_grid_meshes(desc: dict):
    """The ``sphere_grid`` scene's input meshes, made by the benchmark and
    handed to both sides: (the sphere, [per-sphere float32 offsets])."""
    mesh = make_sphere(desc["radius"], rings=desc["rings"],
                       sectors=desc["sectors"])
    g, s = desc["grid"], desc["spacing"]
    offsets = [np.float32([(i % g - (g - 1) / 2) * s,
                           (i // g - (g - 1) / 2) * s, desc["z"]])
               for i in range(g * g)]
    return mesh, offsets


def world_from_doc(doc: dict, camera_position=None) -> World:
    world = World().load(raw_data=json.dumps(doc))
    if camera_position is not None:
        world.main_camera.position = np.asarray(camera_position, np.float32)
    return world


def orbit_positions(doc: dict, first: float, step: float, n: int):
    """(n, 3) float32 camera positions of frames 0..n-1: the world's
    camera orbited by ``first`` before frame 0 and by ``step`` before each
    later frame, with the engine's own orbit arithmetic
    (``CameraDesc.add_movement``)."""
    cam = world_from_doc(doc).main_camera
    out = np.empty((n, 3), np.float32)
    for i in range(n):
        cam.add_movement(first if i == 0 else step, 0.0)
        out[i] = cam.position
    return out


# ------------------------------------------------------------------ math


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True),
                                          1e-20))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _sat(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def look_at(eye, center, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """glm::lookAtRH."""
    eye, center, up = (np.asarray(v, np.float64) for v in (eye, center, up))
    f = center - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    return np.array([[*s, -s @ eye], [*u, -u @ eye], [*-f, f @ eye],
                     [0.0, 0.0, 0.0, 1.0]])


def perspective_vk(fovy: float, aspect: float, near: float,
                   far: float) -> np.ndarray:
    """glm::perspectiveRH_ZO with the Vulkan y flip."""
    t = math.tan(fovy / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = -1.0 / t
    m[2, 2] = far / (near - far)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def _h(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(4, 4) matrix times points (N, 3) with w = 1: (N, 4)."""
    return p @ m[:, :3].T + m[:, 3]


def default_lit(diffuse, roughness, n, v, ndotv, l_dir):
    """DefaultLitBxDF (Common.glsl:259-282) for light direction ``l_dir``:
    (n . l, diffuse (N, 3) + specular)."""
    h = _normalize(v + l_dir)
    ldoth = _sat(_dot(l_dir, h))
    ndoth = _sat(_dot(n, h))
    ndotl = _sat(_dot(n, l_dir))
    f0, f90 = 0.04, 1.0
    f = f0 + (f90 - f0) * (1.0 - ldoth) ** 5
    a2 = roughness * roughness
    ggx = ndotl * torch.sqrt(ndotv * ndotv * (1 - a2) + a2) \
        + ndotv * torch.sqrt(ndotl * ndotl * (1 - a2) + a2)
    vis = torch.where(ggx > 0, 0.5 / torch.where(ggx > 0, ggx, 1.0), 0.0)
    dd = (ndoth * a2 - ndoth) * ndoth + 1.0
    d = a2 / (PI * dd * dd)
    fd90 = 0.5 * roughness + 2.0 * ldoth * ldoth * roughness
    fd = (1 + (fd90 - 1) * (1 - ndotl) ** 5) \
        * (1 + (fd90 - 1) * (1 - ndotv) ** 5) \
        * ((1 - roughness) + roughness / 1.51)
    return ndotl, diffuse * ((1 - f) * fd)[:, None] + (f * d * vis)[:, None]


def tangent_normal(dpdx, dpdy, duvdx, duvdy, frag_normal):
    """ComputeNormal (Common.glsl:113-127) of the flat normal-map value,
    which the shader normalizes before its 2x - 1 remap."""
    den = duvdx[:, 0] * duvdy[:, 1] - duvdy[:, 0] * duvdx[:, 1]
    den = torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    t = (duvdy[:, 1:2] * dpdx - duvdx[:, 1:2] * dpdy) / den[:, None]
    n = _normalize(frag_normal)
    t = _normalize(t - n * _dot(n, t)[:, None])
    b = _normalize(torch.linalg.cross(n, t, dim=-1))
    tn = _normalize(torch.tensor(TEX_NORMAL, dtype=F64, device=n.device))
    m = _normalize(2.0 * tn - 1.0)
    return _normalize(t * m[0] + b * m[1] + n * m[2])


def pcf(shadowmap: torch.Tensor, shadow_space: torch.Tensor,
        world_pos: torch.Tensor, radius: int, scale: float,
        bias: float) -> torch.Tensor:
    """ComputePCF (Common.glsl:323-342): the mean over (2r + 1)^2 nearest
    texels at ``scale`` texels' spacing (repeat addressing) of 0.1 where
    the texel is nearer than the point's light depth, else 1."""
    dim_y, dim_x = shadowmap.shape
    clip = _h(shadow_space, world_pos)
    w = clip[:, 3]
    w = torch.where(w.abs() > 1e-20, w, torch.ones_like(w))
    u = (clip[:, 0] * 0.5 + clip[:, 3] * 0.5) / w
    v = (clip[:, 1] * 0.5 + clip[:, 3] * 0.5) / w
    z = clip[:, 2] / w
    live = (z > -1) & (z < 1) & (clip[:, 3] / w > 0)
    flat = shadowmap.reshape(-1).to(F64)
    occluded = torch.zeros_like(z)
    for oy in range(-radius, radius + 1):
        iy = torch.remainder(torch.floor(v * dim_y + scale * oy).long(), dim_y)
        for ox in range(-radius, radius + 1):
            ix = torch.remainder(torch.floor(u * dim_x + scale * ox).long(),
                                 dim_x)
            occluded += (live & (flat[iy * dim_x + ix] < z - bias)).to(F64)
    taps = (2 * radius + 1) ** 2
    return (occluded * SHADOW_OCCLUDED + (taps - occluded)) / taps


# ------------------------------------------------------------- reference


# Settings whose frames the reference renders only at these values.
RENDERED_AS = dict(enable_deferred=True, enable_shadow=True,
                   enable_skydome=True, enable_background=False,
                   skydome_mode="analytic", wireframe=False, depth_clear=1.0,
                   ablate="")


class Reference:
    def __init__(self, cfg: dict, device="cuda"):
        self.config = EngineConfig(**cfg["settings"])
        other = {k: getattr(self.config, k) for k, v in RENDERED_AS.items()
                 if getattr(self.config, k) != v}
        if other:
            raise ValueError(f"the reference renders no frame with {other}")
        self.doc = cfg["world"]
        self.device = torch.device(device)
        # The configuration's statement: the shadow casters' light-apex
        # cone cull (the shadow map is then judged by a range).
        self.cone_cull = bool(cfg["settings"].get("shadow_cone_cull", False))
        desc = cfg["scene"]
        if desc["kind"] == "world":
            parts = list(world_parts(world_from_doc(self.doc)))
        elif desc["kind"] == "sphere_grid":
            mesh, offsets = sphere_grid_meshes(desc)
            parts = []
            for off in offsets:
                m = dict(mesh.__dict__, positions=mesh.positions + off)
                parts.append(stage(type(mesh)(**m), None, two_sided=False,
                                   deferred=True))
        else:
            raise ValueError(f"unknown scene kind {desc['kind']!r}")
        if not all(p.deferred for p in parts):
            raise ValueError("the reference shades the deferred path only")
        dev, base, idx = self.device, 0, []
        for p in parts:
            idx.append(p.indices + base)
            base += p.positions.shape[0]

        def cat(key):
            return torch.from_numpy(np.concatenate(
                [getattr(p, key) for p in parts])).to(dev, F64)

        self.pos, self.nrm, self.uv = cat("positions"), cat("normals"), \
            cat("uvs")
        self.tri = torch.from_numpy(np.concatenate(idx)).to(dev)
        self.two_sided = torch.from_numpy(np.concatenate(
            [np.full(p.indices.shape[0], p.two_sided) for p in parts])).to(dev)

    # ---------------------------------------------------------------- view

    def view(self, camera_position, doc: Optional[dict] = None) -> dict:
        cfg = self.config
        world = world_from_doc(doc or self.doc, camera_position)
        cam = world.main_camera
        fov = math.radians(float(cam.fov))
        near, far = float(cam.z_near), float(cam.z_far)
        vp = perspective_vk(fov, cfg.width / cfg.height, near, far) \
            @ look_at(cam.position, cam.lookat)
        dirs = world.directional_lights[:cfg.max_directional_lights]
        light_pos = dirs[0].position if dirs else (20.0, 0.0, 20.0)
        sh = perspective_vk(fov, 1.0, near, far) @ look_at(light_pos,
                                                           (0.0, 0.0, 0.0))
        points = []
        pl = world.point_lights[:cfg.max_point_lights]
        for i, light in enumerate(pl):
            # The viewer's spinning ring (ZeldaEngine.cpp:4637-4646).
            ang = math.radians(float(np.float32(i / len(pl) * 360.0)))
            dist = i / len(pl) * 5.0 + 2.5
            points.append((math.sin(ang) * dist, math.cos(ang) * dist, 1.5,
                           light))
        t = dict(dtype=F64, device=self.device)
        return dict(
            view_proj=torch.tensor(vp, **t), shadow_space=torch.tensor(sh, **t),
            camera=torch.tensor(np.asarray(cam.position, np.float64), **t),
            dirs=[(torch.tensor(np.asarray(d.direction, np.float64), **t),
                   torch.tensor(np.asarray(d.color, np.float64), **t),
                   float(d.intensity)) for d in dirs],
            points=[(torch.tensor([x, y, z], **t),
                     torch.tensor(np.asarray(li.color, np.float64), **t),
                     float(li.intensity), float(li.radius))
                    for x, y, z, li in points],
            spots=world.spot_lights[:cfg.max_spot_lights])

    def _clip(self, m: torch.Tensor, control):
        """(clip-space vertices (T, 3, 4), the bound on their terms'
        magnitudes |m| @ |point|) of every triangle."""
        clip = _h(m, self.pos)
        if control:
            clip = clip.to(torch.bfloat16).to(F64)
        bound = _h(m.abs(), self.pos.abs())
        return clip[self.tri], bound[self.tri]

    def _shadow_setup(self, v: dict, two_sided: bool, control=False):
        cfg = self.config
        clip, bound = self._clip(v["shadow_space"], control)
        return raster.setup(
            clip, cfg.shadowmap_dim, cfg.shadowmap_dim, two_sided=two_sided,
            depth_bias=(cfg.shadow_bias_constant, cfg.shadow_bias_slope),
            clip_abs=bound, low=control == "raster")

    def _gbuffer_setup(self, v: dict, control=False):
        cfg = self.config
        clip, bound = self._clip(v["view_proj"], control)
        return raster.setup(clip, cfg.width, cfg.height,
                            two_sided=self.two_sided, clip_abs=bound,
                            low=control == "raster")

    # -------------------------------------------------------------- render

    @torch.no_grad()
    def render(self, camera_position, doc: Optional[dict] = None,
               control=False,
               shadowmap: Optional[torch.Tensor] = None) -> dict:
        """The frame's buffers, with the range each shadow-map texel
        (``shadow_lo`` / ``shadow_hi``) and each GBuffer depth
        (``depth_lo`` / ``depth_hi``) may take under float32 rounding, and
        the pixels whose winner no rounding changes (``settled``). Where
        the configuration states the light-apex cone cull of the casters
        (whose result depends on how the program baked its meshlets), a
        texel's range runs from every caster's to the light-facing
        casters'. The resolve reads the map handed in (the program's,
        judged by its range on its own), or the reference's own."""
        cfg, v = self.config, self.view(camera_position, doc)
        sh_all = self._shadow_setup(v, True, control)
        sh_sure = self._shadow_setup(v, False, control) if self.cone_cull \
            else None
        own = raster.rasterize(sh_sure or sh_all, ids=False)[0]
        lo, hi, _ = raster.bounds(sh_all, sure_st=sh_sure)
        smap = (own if shadowmap is None else shadowmap).to(F64)
        st = self._gbuffer_setup(v, control)
        depth, ids = raster.rasterize(st)
        d_lo, d_hi, settled = raster.bounds(st, ids)
        h, w = cfg.height, cfg.width
        color = torch.zeros((h * w, 3), dtype=F64, device=self.device)
        factor = torch.ones(h * w, dtype=F64, device=self.device)
        pix = torch.nonzero(ids.reshape(-1) >= 0).squeeze(1)
        if pix.numel():
            lit, sf = self._resolve(st, ids.reshape(-1)[pix], pix, smap, v)
            color[pix] = lit
            factor[pix] = sf
        color = self._sky(v, color, depth.reshape(-1))
        color = torch.clamp(color, 0.0, 1.0).reshape(h, w, 3)
        return dict(color=color, u8=quantize_u8(color), shadowmap=own,
                    shadow_lo=lo, shadow_hi=hi, gbuffer_depth=depth,
                    depth_lo=d_lo, depth_hi=d_hi, tri_id=ids,
                    shadow_factor=factor.reshape(h, w), settled=settled)

    def _resolve(self, st, tri, pix, smap, v):
        """(lit colour (N, 3), PCF factor (N,)) of covered pixels ``pix``
        whose nearest triangle is ``tri``."""
        cfg, w = self.config, self.config.width
        px = (pix % w).to(F64) + 0.5
        py = (pix // w).to(F64) + 0.5
        e = st.adj[tri]
        u = raster.edge_values(st, tri, px, py)
        s = u.sum(-1, keepdim=True)
        lam = u / s
        dlx = (e[..., 0] - lam * e[..., 0].sum(-1, keepdim=True)) / s
        dly = (e[..., 1] - lam * e[..., 1].sum(-1, keepdim=True)) / s
        corners = self.tri[tri]

        def mix(attr, weights):
            return (weights[..., None] * attr[corners]).sum(1)

        pos = mix(self.pos, lam)
        normal = tangent_normal(mix(self.pos, dlx), mix(self.pos, dly),
                                mix(self.uv, dlx), mix(self.uv, dly),
                                mix(self.nrm, lam))
        # The GBuffer's attachments: the normal at 10 bits, the material
        # at 8 (round half to even, as the engine's torch.round).
        normal = torch.round((normal + 1.0) * 0.5 * 1023.0) / 1023.0 * 2 - 1
        base = torch.round(torch.tensor(GREY_LINEAR) * 255.0).item() / 255.0
        metallic, roughness, ao, mask = 0.0, 1.0, 1.0, 1.0
        sf = pcf(smap, v["shadow_space"], pos, cfg.pcf_radius,
                 cfg.pcf_scale, cfg.shadow_bias)
        n = _normalize(normal)
        view_dir = _normalize(v["camera"] - pos)
        ndotv = _sat(_dot(n, view_dir))
        diffuse = torch.full_like(pos, base * (1.0 - metallic))
        rough = torch.full_like(ndotv, roughness)
        acc = torch.zeros_like(pos)
        for direction, col, intensity in v["dirs"]:
            ndotl, bxdf = default_lit(diffuse, rough, n, view_dir, ndotv,
                                      _normalize(direction).expand_as(pos))
            acc += (ndotl * intensity)[:, None] * col * bxdf * sf[:, None]
        for lpos, col, intensity, radius in v["points"]:
            to_light = lpos - pos
            ndotl, bxdf = default_lit(diffuse, rough, n, view_dir, ndotv,
                                      _normalize(to_light))
            dist = torch.sqrt(torch.clamp_min(_dot(to_light, to_light), 1e-20))
            att = 1.0 - torch.clamp(dist / max(radius, 1e-6), 0.0, 1.0)
            acc += (ndotl * intensity * att)[:, None] * col * bxdf
        if v["spots"]:
            raise ValueError("the reference shades no spot lights")
        ambient = diffuse / PI * (ao * 0.3 * sf)[:, None]
        lit = torch.pow(torch.clamp_min((acc + ambient) * mask, 0.0), GAMMA)
        return lit, sf

    def _sky(self, v, color, depth):
        """The colour with the analytic dome over the pixels where it lies
        nearer than ``depth``."""
        cfg = self.config
        h, w = cfg.height, cfg.width
        dev = self.device
        py, px = torch.meshgrid(torch.arange(h, dtype=F64, device=dev) + 0.5,
                                torch.arange(w, dtype=F64, device=dev) + 0.5,
                                indexing="ij")
        nx = (px / w * 2 - 1).reshape(-1)
        ny = (py / h * 2 - 1).reshape(-1)
        ndc = torch.stack([nx, ny, torch.full_like(nx, 0.5),
                           torch.ones_like(nx)], -1)
        pw = ndc @ torch.linalg.inv(v["view_proj"]).T
        o = v["camera"]
        d = _normalize(pw[:, :3] / pw[:, 3:] - o)
        r = float(cfg.skydome_radius)
        b = d @ o
        disc = b * b - (o @ o - r * r)
        s = torch.sqrt(torch.clamp_min(disc, 0.0))
        t = torch.where(-b - s > 1e-4, -b - s, -b + s)
        p = o + t[:, None] * d
        clip = _h(v["view_proj"], p)
        cw = clip[:, 3]
        sky_depth = clip[:, 2] / torch.where(cw.abs() > 1e-20, cw,
                                             torch.ones_like(cw))
        hit = (disc >= 0) & (t > 1e-4) & (sky_depth >= 0) & (sky_depth <= 1)
        show = hit & (sky_depth < depth)
        return torch.where(show[:, None], SKY_TEXEL ** GAMMA, color)

    @torch.no_grad()
    def pass_setups(self, camera_position, doc: Optional[dict] = None) -> dict:
        """The setups of the frame's two raster passes, for the rooflines'
        work: the GBuffer pass's triangles at the viewport, and the shadow
        casters at the map (two-sided; one-sided, facing the light, where
        the configuration states the light-apex cone cull, which is exact
        only for the closed meshes it asks for)."""
        v = self.view(camera_position, doc)
        cfg = self.config
        return dict(gbuffer=(self._gbuffer_setup(v), cfg.width, cfg.height),
                    shadow=(self._shadow_setup(v, not self.cone_cull),
                            cfg.shadowmap_dim, cfg.shadowmap_dim))
