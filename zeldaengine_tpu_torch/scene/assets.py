"""Asset discovery and loading.

Mirrors the reference's conventions:
- ``AssetPathSearch`` (ZeldaEngine.cpp:7173-7263): exact path, else scan
  ``Profabs/*/models|textures``, else ``Content/Models|Textures``.
- ``CreateRenderObjectsFromProfabs`` (:4923-5000): for every
  ``Profabs/<name>/models/*.obj``, texture set ``textures/<model>_{bc,m,r,
  n,ao,ev,ms}.png`` with per-slot defaults.
- Basecolor textures are sRGB-decoded at load (the reference samples them
  through VK_FORMAT_R8G8B8A8_SRGB, :4868); all other slots are linear.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from zeldaengine_tpu_torch.config import EngineConfig
from zeldaengine_tpu_torch.math.color import srgb_to_linear
from zeldaengine_tpu_torch.scene.mesh import (
    Mesh,
    load_mesh,
    load_obj,
    make_cube,
    make_plane,
    make_sphere,
)
from zeldaengine_tpu_torch.scene.scenebuild import SceneBuilder
from zeldaengine_tpu_torch.scene.world import World, RenderFlags
from zeldaengine_tpu_torch.utils.image import read_png

SLOT_SUFFIXES = ["_bc", "_m", "_r", "_n", "_ao", "_ev", "_ms"]


def asset_path_search(name: str, roots: List[str]) -> Optional[str]:
    """ASSETS() search order: literal, Profabs scan, Content scan."""
    if os.path.exists(name):
        return name
    base = os.path.basename(name)
    for root in roots:
        profabs = os.path.join(root, "Profabs")
        if os.path.isdir(profabs):
            for folder in sorted(os.listdir(profabs)):
                for sub in ("models", "textures"):
                    p = os.path.join(profabs, folder, sub, base)
                    if os.path.exists(p):
                        return p
        for sub in ("Models", "Textures", "models", "textures"):
            p = os.path.join(root, "Content", sub, base)
            if os.path.exists(p):
                return p
        p = os.path.join(root, name)
        if os.path.exists(p):
            return p
    return None


_TEXTURE_CACHE: dict = {}
_MESH_CACHE: dict = {}


def load_texture_image(path: str, size: int, srgb: bool) -> np.ndarray:
    """PNG -> linear float32, memoized on (path, mtime, size, srgb): the
    livelink reload path rebuilds the whole scene (CreateEngineScene,
    ZeldaEngine.cpp:1943-1951) and must not re-decode unchanged assets."""
    key = (path, os.path.getmtime(path), size, srgb)
    hit = _TEXTURE_CACHE.get(key)
    if hit is not None:
        return hit
    img = read_png(path, size=size)
    if srgb:
        img = np.concatenate(
            [srgb_to_linear(img[..., :3]).numpy(), img[..., 3:]], -1)
    img = np.asarray(img, np.float32)
    img.setflags(write=False)
    _TEXTURE_CACHE[key] = img
    return img


def load_mesh_cached(path: str) -> Mesh:
    """Mesh load memoized on (path, mtime); returns the shared instance
    (treat as read-only)."""
    key = (path, os.path.getmtime(path))
    hit = _MESH_CACHE.get(key)
    if hit is None:
        hit = _MESH_CACHE[key] = load_mesh(path)
    return hit


_PROCEDURAL_CACHE: dict = {}


def _procedural_profab(name: str) -> Mesh:
    """Stand-in meshes when no Profabs assets exist on disk (the reference
    ships an empty Profabs/ dir; scenes come from the livelink). Memoized:
    livelink reloads rebuild the scene every frame in streaming use."""
    hit = _PROCEDURAL_CACHE.get(name)
    if hit is not None:
        return hit
    _PROCEDURAL_CACHE[name] = mesh = _procedural_profab_build(name)
    return mesh


def _procedural_profab_build(name: str) -> Mesh:
    if "terrain" in name or "stage" in name:
        return make_plane(10.0, uv_scale=8.0)
    if "rock" in name:
        return make_sphere(0.4, rings=6, sectors=9)
    if "grass" in name:
        # two crossed quads standing in Z (billboard-ish grass card)
        quads = []
        base = make_plane(0.5)
        for rot in (0.0, np.pi / 2):
            m = base
            c, s = np.cos(rot), np.sin(rot)
            r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            # stand the quad up: xy plane -> xz plane
            stand = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
            pos = (m.positions @ stand.T + np.array([0, 0, 0.5], np.float32)) @ r.T
            nrm = (m.normals @ stand.T) @ r.T
            quads.append((pos.astype(np.float32), nrm.astype(np.float32),
                          m.uvs, m.indices))
        n0 = quads[0][0].shape[0]
        return Mesh(
            positions=np.concatenate([q[0] for q in quads]),
            normals=np.concatenate([q[1] for q in quads]),
            colors=np.ones((2 * n0, 3), np.float32),
            uvs=np.concatenate([q[2] for q in quads]),
            indices=np.concatenate([quads[0][3], quads[1][3] + n0]),
        )
    if "sphere" in name:
        return make_sphere(0.5)
    return make_cube(1.0)


def load_profab(
    sb: SceneBuilder,
    name: str,
    roots: List[str],
    instances: Optional[np.ndarray],
    deferred: bool,
    two_sided: bool = False,
) -> bool:
    """Load every OBJ under Profabs/<name>/models with its texture set;
    falls back to a procedural mesh + default material if absent."""
    size = sb.config.texture_size
    found = False
    for root in roots:
        pdir = os.path.join(root, "Profabs", name)
        mdir = os.path.join(pdir, "models")
        tdir = os.path.join(pdir, "textures")
        if not (os.path.isdir(mdir) and os.path.isdir(tdir)):
            continue
        for f in sorted(os.listdir(mdir)):
            if not f.lower().endswith((".obj", ".fbx")):
                continue
            model_name = os.path.splitext(f)[0]
            mesh = load_mesh_cached(os.path.join(mdir, f))
            slots = {}
            for slot, suffix in enumerate(SLOT_SUFFIXES):
                tp = os.path.join(tdir, model_name + suffix + ".png")
                if os.path.exists(tp):
                    slots[slot] = load_texture_image(tp, size, srgb=(slot == 0))
            mat = sb.add_material(slots)
            sb.add_object(mesh, mat, instances=instances,
                               deferred=deferred, two_sided=two_sided)
            found = True
        if found:
            break
    if not found:
        mesh = _procedural_profab(name)
        mat = sb.add_material({})
        sb.add_object(
            mesh, mat, instances=instances, deferred=deferred,
            two_sided=two_sided or ("grass" in name),
        )
    return found


def scene_asset_fingerprint(world, roots: Optional[List[str]] = None) -> str:
    """(path, mtime) digest of every on-disk asset the scene build would
    touch for this world: Profab models/textures per object desc, the
    skydome mesh, and the sky/cubemap/background images.

    Folded into Engine._scene_content_key so a livelink push of an
    UNCHANGED world still rebuilds when an asset file was edited on disk
    (the reference rebuilds unconditionally, ZeldaEngine.cpp:1943-1951;
    we skip rebuilds only when neither the world nor its assets moved).
    """
    roots = roots or []
    parts: List[str] = []

    def stamp(path):
        if path and os.path.exists(path):
            parts.append(f"{path}:{os.path.getmtime(path)}")

    stamp(asset_path_search("skydome.obj", roots))
    stamp(asset_path_search(world.skydome_file_name, roots))
    for fn in world.cubemap_file_names:
        stamp(asset_path_search(fn, roots))
    stamp(asset_path_search(world.background_file_name, roots))
    for desc in world.object_descs:
        for root in roots:
            pdir = os.path.join(root, "Profabs", desc.profab_name)
            mdir = os.path.join(pdir, "models")
            tdir = os.path.join(pdir, "textures")
            if not os.path.isdir(mdir):
                continue
            for d in (mdir, tdir):
                if os.path.isdir(d):
                    for f in sorted(os.listdir(d)):
                        stamp(os.path.join(d, f))
            break
    import hashlib

    return hashlib.md5("\n".join(parts).encode()).hexdigest()


def build_scene_from_world(
    world: World,
    config: EngineConfig,
    roots: Optional[List[str]] = None,
    instance_seed: int = 0,
    device="cuda",
):
    """CreateEngineScene (ZeldaEngine.cpp:4140): world description ->
    GPU scene pools on ``device``. Returns (GpuScene, SceneMeta)."""
    from zeldaengine_tpu_torch.utils.device import require_device

    device = require_device(device)
    roots = roots or []
    sb = SceneBuilder(config)
    sb.enable_skydome = world.enable_skydome
    sb.enable_background = world.enable_background

    # Real dome geometry when mounted (Content/Models/skydome.obj —
    # CreateSkydomePass loads exactly this asset, ZeldaEngine.cpp:2690).
    dome_path = asset_path_search("skydome.obj", roots)
    if dome_path and world.enable_skydome:
        sb.set_skydome_mesh(load_mesh_cached(dome_path))

    # Sky / cubemap / background textures
    sky_path = asset_path_search(world.skydome_file_name, roots)
    if sky_path:
        sb.set_skydome_texture(
            load_texture_image(sky_path, config.background_size, srgb=False)
        )
    faces = []
    for fn in world.cubemap_file_names:
        p = asset_path_search(fn, roots)
        faces.append(
            load_texture_image(p, config.cubemap_size, srgb=False)
            if p
            else None
        )
    if all(f is not None for f in faces):
        sb.set_cubemap(np.stack(faces))
    bg_path = asset_path_search(world.background_file_name, roots)
    if bg_path:
        sb.set_background_texture(
            load_texture_image(bg_path, config.background_size, srgb=False)
        )

    for i, desc in enumerate(world.object_descs):
        flags = desc.render_flags
        deferred = not bool(flags & int(RenderFlags.FORWARD_SHADING))
        two_sided = bool(flags & int(RenderFlags.TWO_SIDED))
        inst = None
        if desc.instance_count > 1:
            inst = desc.generate_instances(seed=instance_seed + i)
        load_profab(sb, desc.profab_name, roots, inst, deferred, two_sided)

    return sb.build(device)
