"""Host-side scene flattening: meshes/instances/materials -> device SoA pools.

This replaces the reference's per-object GPU state (VkBuffers per mesh,
descriptor sets per material, per-draw vkCmdDraw calls,
ZeldaEngine.cpp:4726-4885). Instead of N objects x (buffers + descriptors),
the whole scene is a handful of flat tensors with integer indices - the
"bindless" design the reference left as a TODO (ENABLE_BINDLESS_TEXTURE,
ZeldaEngine.cpp:96).

Instancing (BaseInstanced.vert) is baked at build time: each (vertex,
instance) pair becomes one entry in the pair pools with the instance
transform pre-applied to positions (static per scene); instance *rotations*
are kept in a small table because the reference applies them to normals
AFTER the dynamic model matrix (BaseInstanced.vert:74).

Everything up to the last step is NumPy on the host; ``build(device)``
uploads each pool once. bfloat16 atlases are packed as float32 arrays of
bf16-rounded values and cast (exactly) at upload.

Packed atlases are cached by content (``cached_atlas``): a device-resident
LRU of ``DEVICE_ATLAS_ENTRIES`` entries shared across rebuilds, so a
livelink reload that keeps its textures pays neither packing nor upload.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.ops.texture import round_bf16
from zeldaengine_tpu_torch.scene.mesh import Mesh, make_sphere
from zeldaengine_tpu_torch.utils.device import require_device


# Packed and uploaded texture atlases keyed by (kind, shape, dtype, md5 of
# the source images, device), least recently used first.
_DEVICE_ATLAS_CACHE: dict = {}
DEVICE_ATLAS_ENTRIES = 8


def cached_atlas(kind: str, images: np.ndarray, build_fn, bf16: bool,
                 device) -> torch.Tensor:
    """``build_fn(images, bf16=bf16)`` (a host packer) uploaded to
    ``device`` as bfloat16 or float32, through a device-resident LRU keyed
    by content. A hit returns the cached tensor itself: atlases are never
    written after the build. The JAX package also keeps the packed atlases
    on disk for a new process; here packing is NumPy, and a disk tier saved
    no time (``tests/torch_atlas_cache_timing.py``, PERF.md)."""
    dtype = "bfloat16" if bf16 else "float32"
    images = np.ascontiguousarray(images)
    dev_key = (kind, tuple(images.shape), dtype,
               hashlib.md5(images).hexdigest(), str(device))
    hit = _DEVICE_ATLAS_CACHE.pop(dev_key, None)
    if hit is None:
        host = np.ascontiguousarray(build_fn(images, bf16=bf16), np.float32)
        hit = torch.from_numpy(host).to(device).to(
            torch.bfloat16 if bf16 else torch.float32)
    while len(_DEVICE_ATLAS_CACHE) >= DEVICE_ATLAS_ENTRIES:
        _DEVICE_ATLAS_CACHE.pop(next(iter(_DEVICE_ATLAS_CACHE)))
    # Re-inserted last: a hit stays alive under rotating world reloads.
    _DEVICE_ATLAS_CACHE[dev_key] = hit
    return hit


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 3 x 10-bit coords (N, 3) into Morton keys (N,)."""

    def spread(x):
        x = x.astype(np.int64)
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _hue2rgb_np(hue: np.ndarray) -> np.ndarray:
    h = hue - np.floor(hue)
    r = np.abs(h * 6.0 - 3.0) - 1.0
    g = 2.0 - np.abs(h * 6.0 - 2.0)
    b = 2.0 - np.abs(h * 6.0 - 4.0)
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


def _make_rot_np(r3: np.ndarray) -> np.ndarray:
    """MakeRotMatrix (Common.glsl:60-87) in numpy; r3 (..., 3) -> (..., 3, 3)."""
    sx, cx = np.sin(r3[..., 0]), np.cos(r3[..., 0])
    sy, cy = np.sin(r3[..., 1]), np.cos(r3[..., 1])
    sz, cz = np.sin(r3[..., 2]), np.cos(r3[..., 2])
    z = np.zeros_like(sx)
    o = np.ones_like(sx)
    mx = np.stack([cx, z, -sx, z, o, z, sx, z, cx], -1).reshape(*sx.shape, 3, 3)
    my = np.stack([cy, -sy, z, sy, cy, z, z, z, o], -1).reshape(*sx.shape, 3, 3)
    mz = np.stack([o, z, z, z, cz, -sz, z, sz, cz], -1).reshape(*sx.shape, 3, 3)
    return mz @ my @ mx


# PBR texture slot order (Base.frag:24-30 / CreateRenderObjectsFromProfabs
# :4951-4989): basecolor, metallic, roughness, normal, AO, emissive, mask.
SLOT_BASECOLOR, SLOT_METALLIC, SLOT_ROUGHNESS, SLOT_NORMAL = 0, 1, 2, 3
SLOT_AO, SLOT_EMISSIVE, SLOT_MASK = 4, 5, 6


def default_slot_images(size: int) -> dict:
    """Default textures per slot (CreateRenderObjectsFromProfabs fallbacks:
    grey basecolor, black metallic/emissive, white roughness/AO/mask, flat
    normal)."""

    def solid(rgb):
        img = np.zeros((size, size, 4), np.float32)
        img[..., :3] = rgb
        img[..., 3] = 1.0
        return img

    # basecolor default_grey.png is 0.5 sRGB -> linear ~0.2140
    grey_lin = ((0.5 + 0.055) / 1.055) ** 2.4
    return {
        SLOT_BASECOLOR: solid([grey_lin] * 3),
        SLOT_METALLIC: solid([0.0, 0.0, 0.0]),
        SLOT_ROUGHNESS: solid([1.0, 1.0, 1.0]),
        SLOT_NORMAL: solid([0.5, 0.5, 1.0]),
        SLOT_AO: solid([1.0, 1.0, 1.0]),
        SLOT_EMISSIVE: solid([0.0, 0.0, 0.0]),
        SLOT_MASK: solid([1.0, 1.0, 1.0]),
    }


class GpuScene(NamedTuple):
    """Device-resident scene: a flat tuple of tensors on one device."""

    # vertex pairs (post-instancing vertex pool)
    pair_pos: torch.Tensor  # (P, 3) instance-staged local positions
    pair_nrm: torch.Tensor  # (P, 3) local normals (normalized)
    pair_rot: torch.Tensor  # (P,) int32 index into rot_table
    rot_table: torch.Tensor  # (R, 3, 3) instance normal rotations (R^T), [0]=I

    # triangles
    tri_vtx: torch.Tensor  # (T, 3) int32 pair indices
    tri_two_sided: torch.Tensor  # (T,) bool
    tri_deferred: torch.Tensor  # (T,) bool: deferred (True) vs forward
    tri_valid: torch.Tensor  # (T,) bool

    # packed hot-path attribute pools (one gather each in the deferred
    # attribute pass); per-slot uv/color and per-tri material live ONLY
    # here — the unpacked copies are host-side intermediates.
    pair_static: torch.Tensor  # (P, 8) f32: uv(2), color(3), pad(3)
    tri_meta: torch.Tensor  # (T, 4) i32: v0, v1, v2, material

    # materials + textures
    # Per unique material texture-combo, ONE 16-channel supertexture mip
    # atlas [bc.rgb, nrm.rgb, em.rgb, metallic, roughness, ao, mask,
    # pad*3]: one row fetch returns every texture's texel at once.
    mat_combined: torch.Tensor  # (M,) int32 -> combined_atlas layer
    combined_atlas: torch.Tensor  # (Mc, S, 2S, 208) bf16 (mip-pair-packed)
    cube_atlas: torch.Tensor  # (6, Sc, Sc/2, 64) quad-packed cubemap faces
    sky_tex: torch.Tensor  # (1, Ss, Ss/2, 64) quad-packed skydome equirect
    bg_tex: torch.Tensor  # (1, Sb, Sb/2, 64) quad-packed background texture

    # skydome mesh (inside-out sphere; Content/Models/skydome.obj analogue)
    sky_pos: torch.Tensor  # (Vs, 3)
    sky_uv: torch.Tensor  # (Vs, 2)
    sky_tri: torch.Tensor  # (Ts, 3)
    # (radius, u_phase) of the dome sphere — the analytic skydome path
    # reproduces the mesh's equirect mapping exactly (skydome.obj maps
    # u = azimuth/2pi + 0.75).
    sky_params: torch.Tensor  # (2,) f32

    # GPU-driven meshlet path (the reference's indirect-draw data,
    # XkMeshlet ZeldaEngine.cpp:689 / vkCmdDrawIndexedIndirect :3616,
    # with the frustum+cone cull actually executed per frame)
    meshlet_records: torch.Tensor  # (M, 16) from MeshletSet.arrays()
    tri_meshlet: torch.Tensor  # (T,) int32 meshlet id per triangle (-1 none)

    # Merged environment table (cube reflection + sky + background rows
    # fused for a one-gather-per-pixel env fetch; None when
    # config.env_merge is off). Row offsets live in SceneMeta.env_shapes.
    env_table: Optional[torch.Tensor] = None  # (R, 208) bf16

    # Raw sky/background image planes for the bilinear tap kernel
    # (ops/window_tap.py): (4, S, S) f32 holding the same bf16-rounded
    # values the quad atlases store.
    sky_planes: Optional[torch.Tensor] = None
    bg_planes: Optional[torch.Tensor] = None

    # Low-tier cubemap: RGB mip-pair atlas of the HALF-RES cube (levels
    # 1..max of the full chain - level k here is exactly level k+1 of
    # cube_atlas, same f32 box-mean chain, same bf16 rounding).
    # Reflection lods >= 1 (roughness >= 0.031 - the reference's mip
    # formula, Common.glsl:191-198) are served EXACTLY by one row fetch
    # here. None disables the tier.
    cube_pair1: Optional[torch.Tensor] = None

    # Constant-lod reflection table: when the scene's minimum material
    # roughness is exactly 1.0, EVERY reflection tap reads the cubemap
    # at one fixed mip (maxmip-2, Common.glsl:191-198) whose faces are
    # 2x2 texels - the whole tap collapses to a per-face bilinear over
    # these 6x2x2 texels (selects, no gather). Values are the SAME
    # box-mean chain + bf16 rounding the pair atlas stores, so the output
    # is bit-identical.
    cube_const: Optional[torch.Tensor] = None  # (6, 2, 2, 3) f32

    # Constant-slot elision (per-combo scalar channels): texel (0, 0) of
    # every combo's 16-channel combined image. Channels that are
    # SPATIALLY CONSTANT in every combo (the norm - the reference
    # defaults missing PBR slots to solid textures,
    # CreateRenderObjectsFromProfabs ZeldaEngine.cpp:4951-4989) are
    # dropped from ``combined_atlas`` and served from this tiny table
    # instead; ``SceneMeta.tex_channels`` lists the channels that stayed
    # in the atlas.
    mat_const: Optional[torch.Tensor] = None  # (Mc, 16) f32


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static companion info (host-side facts that pick code paths)."""

    enable_skydome: bool = True
    enable_background: bool = False
    num_triangles: int = 0
    num_pairs: int = 0
    num_instances: int = 0
    has_deferred: bool = True
    has_forward: bool = True
    has_meshlets: bool = False
    num_meshlets: int = 0
    # (cube (6,S,S/2), sky (1,Ss,Ss/2), bg (1,Sb,Sb/2)) atlas shapes of
    # the merged env table; None when env_merge is off.
    env_shapes: Optional[tuple] = None
    # Channels (of the 16-channel combined layout) that vary spatially
    # and therefore live in ``combined_atlas``; the rest come from
    # ``GpuScene.mat_const``. None = legacy full-16 atlas.
    tex_channels: Optional[tuple] = None
    # Static scene facts that shrink the fused raster records
    # (rasterize_cuda.fused_extra_width): the single material-combo id
    # shared by every triangle (None when combos vary). ``flat_normal``
    # would mark a scene whose constant normal-map value survives the
    # reference's normalize-before-remap TBN quirk (Common.glsl:126) as
    # exactly tangent +Z — the shipped default (0.5, 0.5, 1) does NOT
    # (it tilts along the uv tangent frame), so this stays False and
    # the uv/derivative record columns are never elided.
    const_combo: Optional[int] = None
    flat_normal: bool = False


class SceneBuilder:
    """Accumulates meshes/materials/textures, then builds flat pools."""

    def __init__(self, config: EngineConfig):
        self.config = config
        s = config.texture_size
        self._defaults = default_slot_images(s)
        self.textures: List[np.ndarray] = [
            self._defaults[i] for i in range(7)
        ]  # layers 0-6 = per-slot defaults
        self.materials: List[np.ndarray] = []
        self._pair_pos: List[np.ndarray] = []
        self._pair_nrm: List[np.ndarray] = []
        self._pair_col: List[np.ndarray] = []
        self._pair_uv: List[np.ndarray] = []
        self._pair_rot: List[np.ndarray] = []
        # Blocks of (Ni, 3, 3) rotation matrices; slot 0 is the identity.
        self._rots: List[np.ndarray] = [np.eye(3, dtype=np.float32)[None]]
        self._rot_count = 1
        self._tri_vtx: List[np.ndarray] = []
        self._tri_mat: List[np.ndarray] = []
        self._tri_two_sided: List[np.ndarray] = []
        self._tri_deferred: List[np.ndarray] = []
        self._tri_meshlet: List[np.ndarray] = []
        self._meshlet_records: List[np.ndarray] = []
        self._num_instances = 0

        cs = config.cubemap_size
        self.cube_faces = np.zeros((6, cs, cs, 4), np.float32)
        self.cube_faces[..., 3] = 1.0
        ss = config.background_size
        self.sky_image = np.full((ss, ss, 4), 0.25, np.float32)
        self.bg_image = np.zeros((ss, ss, 4), np.float32)
        self.enable_skydome = True
        self.enable_background = False
        # 12x24 is visually indistinguishable for an equirect-textured dome
        # and costs a quarter of the raster work of the 24x48 version.
        sky_mesh = make_sphere(
            getattr(config, "skydome_radius", 30.0), rings=12, sectors=24,
            inward=True,
        )
        self._sky_mesh = sky_mesh
        self._sky_params = np.array(
            [getattr(config, "skydome_radius", 30.0), 0.0], np.float32
        )

    def set_skydome_mesh(self, mesh: Mesh) -> None:
        """Use a real dome asset (e.g. Content/Models/skydome.obj) instead
        of the procedural sphere. Derives the sphere radius and the
        equirect U phase so the analytic skydome path matches the asset's
        UV mapping."""
        self._sky_mesh = mesh
        r = np.linalg.norm(mesh.positions, axis=1)
        radius = float(r.mean())
        p = mesh.positions / np.maximum(r[:, None], 1e-9)
        u_pred = np.mod(np.arctan2(p[:, 1], p[:, 0]) / (2 * np.pi), 1.0)
        # Exclude pole vertices (azimuth undefined there).
        ok = np.abs(p[:, 2]) < 0.99
        shift = np.mod(mesh.uvs[ok, 0] - u_pred[ok], 1.0)
        u_phase = float(np.median(shift)) if ok.any() else 0.0
        self._sky_params = np.array([radius, u_phase], np.float32)

    # ---------------------------------------------------------------- assets

    def add_texture(self, image: np.ndarray) -> int:
        """image: (S, S, 4) float32 linear-space; returns layer index."""
        s = self.config.texture_size
        assert image.shape == (s, s, 4), f"texture must be ({s},{s},4)"
        self.textures.append(np.asarray(image, np.float32))
        return len(self.textures) - 1

    def add_material(self, slots: Optional[dict] = None) -> int:
        """slots: {slot_index: texture_layer or (S,S,4) image}. Missing slots
        use the per-slot defaults (layers 0-6)."""
        layers = list(range(7))
        for slot, val in (slots or {}).items():
            if isinstance(val, (int, np.integer)):
                layers[slot] = int(val)
            else:
                layers[slot] = self.add_texture(val)
        self.materials.append(np.asarray(layers, np.int32))
        return len(self.materials) - 1

    def set_cubemap(self, faces: np.ndarray) -> None:
        """faces: (6, S, S, 3|4) in +X,-X,+Y,-Y,+Z,-Z order."""
        cs = self.config.cubemap_size
        assert faces.shape[0] == 6 and faces.shape[1] == cs
        self.cube_faces[..., : faces.shape[-1]] = faces

    def set_skydome_texture(self, image: np.ndarray) -> None:
        self.sky_image[..., : image.shape[-1]] = image

    def set_background_texture(self, image: np.ndarray) -> None:
        self.bg_image[..., : image.shape[-1]] = image

    # --------------------------------------------------------------- objects

    def add_object(
        self,
        mesh: Mesh,
        material: int,
        instances: Optional[np.ndarray] = None,
        two_sided: bool = False,
        deferred: bool = True,
    ) -> None:
        """Add a render object; ``instances`` is (N, 8) from
        ObjectDesc.generate_instances (pos3, rot3, pscale, tex_index)."""
        v = mesh.num_vertices
        if instances is None:
            instances = np.zeros((1, 8), np.float32)
            instances[0, 6] = 1.0  # scale 1
            plain = True
        else:
            plain = False
        n_inst = instances.shape[0]
        self._num_instances += n_inst

        # Rotation table entries: R^T per instance (normals get p*mat3(R)).
        # Vectorized (no per-instance Python): identity rotations map to
        # table slot 0; the rest are appended as one block.
        rot_mats = _make_rot_np(instances[:, 3:6]).transpose(0, 2, 1)
        identity = np.abs(instances[:, 3:6]).sum(-1) == 0
        rot_idx = np.zeros(n_inst, np.int32)
        nonid = np.flatnonzero(~identity)
        if nonid.size:
            rot_idx[nonid] = self._rot_count + np.arange(
                nonid.size, dtype=np.int32
            )
            self._rots.append(rot_mats[nonid].astype(np.float32))
            self._rot_count += nonid.size

        # Stage positions: p' = (p * scale) * mat3(R) + t  (= R^T (s p) + t).
        base = mesh.positions  # (V, 3)
        scaled = base[None, :, :] * instances[:, None, 6:7]
        staged = np.einsum("nij,nvj->nvi", rot_mats, scaled) + instances[:, None, :3]

        # Debug vertex colors: plain path = Hue2RGB(vertex_index * 1.71)
        # (Base.vert:30); instanced = Hue2RGB(texIndex * 1.71)
        # (BaseInstanced.vert:74).
        if plain:
            col = _hue2rgb_np(np.arange(v, dtype=np.float32) * 1.71)
            cols = np.broadcast_to(col, (n_inst, v, 3))
        else:
            col = _hue2rgb_np(instances[:, 7] * 1.71)  # (N, 3)
            cols = np.broadcast_to(col[:, None, :], (n_inst, v, 3))

        base_pair = sum(p.shape[0] for p in self._pair_pos)
        self._pair_pos.append(staged.reshape(-1, 3).astype(np.float32))
        self._pair_nrm.append(
            np.broadcast_to(mesh.normals, (n_inst, v, 3)).reshape(-1, 3).copy()
        )
        self._pair_col.append(cols.reshape(-1, 3).astype(np.float32))
        self._pair_uv.append(
            np.broadcast_to(mesh.uvs, (n_inst, v, 2)).reshape(-1, 2).copy()
        )
        self._pair_rot.append(np.repeat(rot_idx, v))

        t = mesh.num_triangles
        tri = (
            mesh.indices[None, :, :]
            + (base_pair + np.arange(n_inst)[:, None, None] * v)
        ).reshape(-1, 3)
        self._tri_vtx.append(tri.astype(np.int32))
        self._tri_mat.append(np.full(t * n_inst, material, np.int32))
        self._tri_two_sided.append(np.full(t * n_inst, two_sided, bool))
        self._tri_deferred.append(np.full(t * n_inst, deferred, bool))
        self._tri_meshlet.append(np.full(t * n_inst, -1, np.int32))

    def add_meshlet_object(self, meshlet_set, material: int,
                           two_sided: bool = False,
                           deferred: bool = True,
                           instances: Optional[np.ndarray] = None) -> None:
        """Add a baked meshlet object (the indirect-draw path:
        CreateMeshVertexBuffers<XkMeshIndirect>, ZeldaEngine.cpp:4733-4756):
        vertices re-expanded by meshletVertices, triangles from the 8-bit
        local index stream, one cullable record per meshlet.

        ``instances`` (N, 8: pos3 rot3 pscale texIndex) replicates the
        object with baked transforms — the indirect-INSTANCED class the
        reference records at ZeldaEngine.cpp:3597-3635 — with per-instance
        meshlet records so culling stays per (meshlet, instance)."""
        ms = meshlet_set
        verts = ms.vertices  # (V, 8): pos3, nrm3, uv2
        # Expanded vertex pool in meshlet-vertex order.
        vids = ms.meshlet_vertices.astype(np.int64)
        pos1 = verts[vids, 0:3].astype(np.float32)
        nrm1 = verts[vids, 3:6].astype(np.float32)
        uv1 = verts[vids, 6:8].astype(np.float32)
        n_exp = pos1.shape[0]

        if instances is None:
            instances = np.zeros((1, 8), np.float32)
            instances[0, 6] = 1.0
        n_inst = instances.shape[0]
        self._num_instances += n_inst

        rot_mats = _make_rot_np(instances[:, 3:6]).transpose(0, 2, 1)
        identity = np.abs(instances[:, 3:6]).sum(-1) == 0
        rot_idx = np.zeros(n_inst, np.int32)
        nonid = np.flatnonzero(~identity)
        if nonid.size:
            rot_idx[nonid] = self._rot_count + np.arange(
                nonid.size, dtype=np.int32
            )
            self._rots.append(rot_mats[nonid].astype(np.float32))
            self._rot_count += nonid.size

        base_pair = sum(p.shape[0] for p in self._pair_pos)
        scaled = pos1[None] * instances[:, None, 6:7]
        staged = np.einsum("nij,nvj->nvi", rot_mats, scaled) \
            + instances[:, None, :3]
        col = _hue2rgb_np(np.arange(n_exp, dtype=np.float32) * 1.71)
        self._pair_pos.append(staged.reshape(-1, 3).astype(np.float32))
        self._pair_nrm.append(
            np.broadcast_to(nrm1, (n_inst, n_exp, 3)).reshape(-1, 3).copy()
        )
        self._pair_col.append(
            np.broadcast_to(col, (n_inst, n_exp, 3))
            .reshape(-1, 3).astype(np.float32)
        )
        self._pair_uv.append(
            np.broadcast_to(uv1, (n_inst, n_exp, 2)).reshape(-1, 2).copy()
        )
        self._pair_rot.append(np.repeat(rot_idx, n_exp))

        n_rec = sum(len(r) for r in self._meshlet_records)
        tri_list = []
        local_ids = []
        for mi, m in enumerate(ms.meshlets):
            tris = ms.meshlet_triangles[
                m.triangle_offset : m.triangle_offset + m.triangle_count * 3
            ].reshape(-1, 3).astype(np.int32)
            tri_list.append(tris + m.vertex_offset)
            local_ids.append(np.full(tris.shape[0], mi, np.int32))
        tri1 = np.concatenate(tri_list)  # object-local pair indices
        lid1 = np.concatenate(local_ids)
        t1 = tri1.shape[0]
        n_mesh = len(ms.meshlets)

        # Replicate triangles and meshlet ids per instance.
        tri = (
            tri1[None, :, :]
            + (base_pair + np.arange(n_inst)[:, None, None] * n_exp)
        ).reshape(-1, 3)
        mesh_ids = (
            lid1[None, :]
            + (n_rec + np.arange(n_inst)[:, None] * n_mesh)
        ).reshape(-1)
        t = tri.shape[0]
        self._tri_vtx.append(tri.astype(np.int32))
        self._tri_mat.append(np.full(t, material, np.int32))
        self._tri_two_sided.append(np.full(t, two_sided, bool))
        self._tri_deferred.append(np.full(t, deferred, bool))
        self._tri_meshlet.append(mesh_ids.astype(np.int32))

        # Per-instance cull records: transform bounds/cone by the instance.
        rec1 = np.asarray(ms.arrays(), np.float32)  # (M, 16)
        recs = np.broadcast_to(rec1, (n_inst, n_mesh, 16)).copy()
        s = instances[:, None, 6:7]
        recs[..., 4:7] = (
            np.einsum("nij,nmj->nmi", rot_mats, rec1[None, :, 4:7] * s)
            + instances[:, None, :3]
        )
        recs[..., 7] = rec1[None, :, 7] * instances[:, None, 6]
        recs[..., 8:11] = (
            np.einsum("nij,nmj->nmi", rot_mats, rec1[None, :, 8:11] * s)
            + instances[:, None, :3]
        )
        recs[..., 11:14] = np.einsum(
            "nij,nmj->nmi", rot_mats, np.broadcast_to(
                rec1[None, :, 11:14], (n_inst, n_mesh, 3))
        )
        self._meshlet_records.append(recs.reshape(-1, 16))

    # ----------------------------------------------------------------- build

    def build(self, device="cuda") -> tuple[GpuScene, SceneMeta]:
        """Flatten to pools and upload them to ``device`` (raises when
        ``device`` is a CUDA device and no card is present)."""
        device = require_device(device)
        def cat(parts, dtype, width=None):
            if not parts:
                shape = (0,) if width is None else (0, width)
                return np.zeros(shape, dtype)
            return np.concatenate(parts).astype(dtype)

        pair_pos = cat(self._pair_pos, np.float32, 3)
        pair_nrm = cat(self._pair_nrm, np.float32, 3)
        pair_col = cat(self._pair_col, np.float32, 3)
        pair_uv = cat(self._pair_uv, np.float32, 2)
        pair_rot = cat(self._pair_rot, np.int32)
        tri_vtx = cat(self._tri_vtx, np.int32, 3)
        tri_mat = cat(self._tri_mat, np.int32)
        tri_two = cat(self._tri_two_sided, bool)
        tri_def = cat(self._tri_deferred, bool)
        tri_msh = cat(self._tri_meshlet, np.int32)

        n_pairs = pair_pos.shape[0]
        n_tris = tri_vtx.shape[0]

        # Spatial (Morton) triangle ordering: scattered instancing
        # (ring-scattered grass) is reordered by world position so that
        # consecutive triangle ids are near each other on screen.
        if n_tris > 1:
            cent = pair_pos[tri_vtx].mean(axis=1)
            lo = cent.min(axis=0)
            span = np.maximum(cent.max(axis=0) - lo, 1e-9)
            q = ((cent - lo) / span * 1023.0).astype(np.int64)
            order = np.argsort(_morton3(q), kind="stable")
            tri_vtx = tri_vtx[order]
            tri_mat = tri_mat[order]
            tri_two = tri_two[order]
            tri_def = tri_def[order]
            tri_msh = tri_msh[order]

        # Pad to chunk-friendly sizes (and at least one chunk).
        def pad_to(n, m):
            return max(m, ((n + m - 1) // m) * m)

        p_cap = pad_to(n_pairs, 8)
        t_cap = pad_to(n_tris, self.config.tri_chunk)

        def padn(a, cap):
            pad = cap - a.shape[0]
            return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))

        tri_valid = np.zeros(t_cap, bool)
        tri_valid[:n_tris] = True

        mats = (
            np.stack(self.materials)
            if self.materials
            else np.arange(7, dtype=np.int32)[None]
        )

        # Composite the scalar slots (metallic, roughness, AO, mask) of each
        # material into one RGBA texture; dedup identical combinations.
        composite_cache = {}
        mat_packed = np.zeros((mats.shape[0], 4), np.int32)
        for mi, layers in enumerate(mats):
            key = (int(layers[1]), int(layers[2]), int(layers[4]),
                   int(layers[6]))
            if key not in composite_cache:
                img = np.zeros_like(self.textures[0])
                img[..., 0] = self.textures[key[0]][..., 0]
                img[..., 1] = self.textures[key[1]][..., 0]
                img[..., 2] = self.textures[key[2]][..., 0]
                img[..., 3] = self.textures[key[3]][..., 0]
                self.textures.append(img)
                composite_cache[key] = len(self.textures) - 1
            mat_packed[mi] = [layers[0], layers[3], layers[5],
                              composite_cache[key]]

        # Combined supertextures (mip atlases built per unique combo),
        # mip-pair-packed so ONE row fetch returns the whole trilinear
        # footprint (2x2 at level l + 3x3 at l+1).
        from zeldaengine_tpu_torch.ops.texture import (
            build_mip_pair_atlas as _bmp_np,
            build_mip_pair_atlas_host as _bmp,
            build_quad_packed_atlas_host as _bma,
        )

        def _planes_f32(images, bf16=False):
            # (1, S, S, C) -> (C, S, S) f32 with the quad atlas's bf16
            # rounding, for the sky/bg bilinear tap kernel.
            img = round_bf16(np.asarray(images[0], np.float32))
            return np.ascontiguousarray(np.moveaxis(img, -1, 0))

        def _build_cube_pair1(images, bf16=True):
            # Half-res RGB mip-pair cube (GpuScene.cube_pair1): box-mean
            # the faces once (the same 2x2 f32 mean the full chain
            # uses), drop alpha, pair-pack. Level k == cube level k+1
            # exactly.
            img = np.asarray(images, np.float32)
            n, s, _, c = img.shape
            lvl1 = img.reshape(n, s // 2, 2, s // 2, 2, c).mean((2, 4))
            return round_bf16(_bmp_np(lvl1[..., :3]))

        def upload(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
            return t if dtype is None else t.to(dtype)

        def atlas(kind, images, build_fn, bf16=True):
            # Packed on the host, uploaded once (or found in the atlas
            # caches); bf16 atlases hold bf16-exact f32 values, so the cast
            # loses nothing.
            return cached_atlas(kind, images, build_fn, bf16, device)

        combo_cache = {}
        mat_combined = np.zeros((mats.shape[0],), np.int32)
        combined_imgs = []
        for mi in range(mats.shape[0]):
            bc, nrm, em, pk = (int(v) for v in mat_packed[mi])
            key = (bc, nrm, em, pk)
            if key not in combo_cache:
                sS = self.config.texture_size
                img16 = np.zeros((sS, sS, 16), np.float32)
                img16[..., 0:3] = self.textures[bc][..., :3]
                img16[..., 3:6] = self.textures[nrm][..., :3]
                img16[..., 6:9] = self.textures[em][..., :3]
                img16[..., 9:13] = self.textures[pk]
                combined_imgs.append(img16)
                combo_cache[key] = len(combined_imgs) - 1
            mat_combined[mi] = combo_cache[key]
        # Constant-slot elision: channels that are spatially constant in
        # EVERY combo (defaults like flat normals, black emissive, solid
        # metallic/roughness/AO/mask) are served per-combo from the tiny
        # mat_const table; only varying channels pay the per-pixel atlas
        # tap.
        stack16 = np.stack(combined_imgs)  # (Mc, S, S, 16)
        mc = stack16.shape[0]
        flat = stack16.reshape(mc, -1, 16)
        var_mask = (flat.max(axis=1) - flat.min(axis=1)).max(axis=0) > 0.0
        tex_channels = tuple(int(c) for c in np.nonzero(var_mask)[0])
        # bf16-round the constants: the atlas path stored bf16 texels, so
        # rounding keeps constant channels BIT-IDENTICAL to the gathered
        # values (a lerp of equal values is the value).
        mat_const = upload(round_bf16(stack16[:, 0, 0, :]))
        atlas_src = (stack16[..., list(tex_channels)] if tex_channels
                     else stack16[..., :1])
        combined_atlas = atlas("combined", atlas_src, _bmp)

        pair_static = np.zeros((p_cap, 8), np.float32)
        pair_static[:n_pairs, 0:2] = pair_uv
        pair_static[:n_pairs, 2:5] = pair_col
        tri_meta = np.zeros((t_cap, 4), np.int32)
        tri_meta[:n_tris, :3] = tri_vtx
        tri_meta[:n_tris, 3] = tri_mat

        if self._meshlet_records:
            meshlet_records = np.concatenate(self._meshlet_records)
        else:
            meshlet_records = np.zeros((1, 16), np.float32)
        tri_meshlet_arr = np.full(t_cap, -1, np.int32)
        tri_meshlet_arr[:n_tris] = tri_msh

        # Quad-packed cube rows.
        cube_atlas = atlas("cube", self.cube_faces, _bma)
        # Static shininess gate for the low-tier cube: the pair1 path is
        # exact only when every pixel's reflection lod >= 1, i.e. the
        # scene's minimum material roughness >= 0.031 (Common.glsl mip
        # formula). Shinier scenes keep the full-res quad path. (The
        # Details-panel roughness OVERRIDE multiplies below this bound
        # only in debug sessions; set cube_low_tier=False for exact
        # near-mirror overrides.)
        min_rough = min(
            (float(img[..., 10].min()) for img in combined_imgs),
            default=1.0,
        )
        cube_pair1 = (
            atlas("cube_p1", self.cube_faces, _build_cube_pair1)
            if self.config.cube_low_tier and min_rough >= 0.031 else None
        )
        # Constant-lod reflection (GpuScene.cube_const): at min roughness
        # exactly 1.0 every reflection tap reads mip maxmip-2 = 2x2 faces
        # — precompute those 6x2x2 texels with the SAME np box-mean chain
        # + bf16 rounding the pair atlas stores (bit-identical output).
        cube_const = None
        if cube_pair1 is not None and min_rough >= 1.0:
            lv = np.asarray(self.cube_faces, np.float32)
            while lv.shape[1] > 2:
                n6, sz = lv.shape[0], lv.shape[1]
                lv = lv.reshape(n6, sz // 2, 2, sz // 2, 2,
                                lv.shape[-1]).mean(axis=(2, 4))
            cube_const = upload(round_bf16(lv[..., :3]))
        sky_tex = atlas("sky", self.sky_image[None], _bma)
        bg_tex = atlas("bg", self.bg_image[None], _bma)
        env_table = None
        env_shapes = None
        if self.config.env_merge:
            # One (R, 208) bf16 table for the merged environment tap
            # (ops/envtap.py): quad+pair cube rows, then the sky's and
            # the background's quad rows, channel-padded.
            from zeldaengine_tpu_torch.ops.envtap import flatten_env_tables
            from zeldaengine_tpu_torch.ops.texture import (
                build_quad_pair_atlas_host as _bqp,
            )

            cube_qp = atlas("cube_qp", self.cube_faces, _bqp)
            env_table, _rows = flatten_env_tables(cube_qp, sky_tex, bg_tex)
            env_shapes = (tuple(cube_qp.shape[:3]),
                          tuple(sky_tex.shape[:3]),
                          tuple(bg_tex.shape[:3]))
            del cube_qp

        sky = self._sky_mesh
        scene = GpuScene(
            pair_pos=upload(padn(pair_pos, p_cap)),
            pair_nrm=upload(padn(pair_nrm, p_cap)),
            pair_rot=upload(padn(pair_rot, p_cap)),
            rot_table=upload(np.concatenate(self._rots, axis=0)),
            tri_vtx=upload(padn(tri_vtx, t_cap)),
            tri_two_sided=upload(padn(tri_two, t_cap)),
            tri_deferred=upload(padn(tri_def, t_cap)),
            tri_valid=upload(tri_valid),
            pair_static=upload(pair_static),
            tri_meta=upload(tri_meta),
            mat_combined=upload(mat_combined),
            combined_atlas=combined_atlas,
            # Cube/sky/background are quad-packed 2x2 (4 x-adjacent
            # bases per 64-ch row), stored bf16: 8-bit texture sources
            # carry less precision than bf16 keeps, and samplers cast
            # fetched texels back to f32 before filtering.
            cube_atlas=cube_atlas,
            sky_tex=sky_tex,
            bg_tex=bg_tex,
            sky_pos=upload(sky.positions),
            sky_uv=upload(sky.uvs),
            sky_tri=upload(sky.indices),
            sky_params=upload(self._sky_params),
            meshlet_records=upload(meshlet_records),
            tri_meshlet=upload(tri_meshlet_arr),
            env_table=env_table,
            sky_planes=atlas("sky_pl", self.sky_image[None], _planes_f32,
                             bf16=False),
            bg_planes=atlas("bg_pl", self.bg_image[None], _planes_f32,
                            bf16=False),
            cube_pair1=cube_pair1,
            cube_const=cube_const,
            mat_const=mat_const,
        )
        meta = SceneMeta(
            enable_skydome=self.enable_skydome,
            enable_background=self.enable_background,
            num_triangles=n_tris,
            num_pairs=n_pairs,
            num_instances=self._num_instances,
            has_deferred=bool(tri_def.any()),
            has_forward=bool((~tri_def).any() and n_tris > 0),
            has_meshlets=bool(self._meshlet_records),
            num_meshlets=int(meshlet_records.shape[0])
            if self._meshlet_records else 0,
            env_shapes=env_shapes,
            tex_channels=tex_channels,
            const_combo=0 if len(combined_imgs) == 1 else None,
        )
        return scene, meta
