"""Scene build time with and without the atlas cache's device LRU
(``scene/scenebuild.py::cached_atlas``) and with a disk tier of the packed
host bytes, the JAX package's second tier, on one CUDA card:

    python3 tests/torch_atlas_cache_timing.py [--out FILE] [--device cuda]
        [--grass N --rocks N]

Two scenes, as ``chip_smoke.py`` builds them: bench config 3t's textured
demo (grass 10000, rocks 65) and config 5's world (the scene a livelink
reload of that config rebuilds). For each scene, one process per tier
setting, twice over:

- ``off``: no disk tier; the process builds the scene three times, so
  builds 2 and 3 are served by the device LRU;
- ``disk_cold``: a disk tier on an empty directory, so build 1 packs and
  writes (one ``.npz`` an atlas, bf16 atlases as their 16 bits, as the
  JAX package stores them);
- ``disk_warm``: a new process on that directory, so build 1 reads it.

The disk tier is this script's (``disk_tier``): the port has none, since
it saved no time here (PERF.md, PR 10).

Each process first builds a small unrelated scene, so that the card's
context and the lazy imports are not in the timed builds. Per build it
reports the wall seconds (``build_s``, ending in a synchronise) and the
seconds spent inside ``cached_atlas`` (``atlas_s``: packing, disk, upload)
with the number of atlases packed. Prints one JSON line per process, then
a summary (medians per setting) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("config3t", "config5")
BUILDS = 3


def disk_tier(disk: str, build_fn):
    """``build_fn`` behind a disk tier of the packed host atlases in
    ``disk``, keyed by content (kind, shape, dtype, md5 of the images)."""
    import numpy as np

    def packed(images, bf16):
        dtype = "bfloat16" if bf16 else "float32"
        tag = hashlib.md5(f"{images.shape}|{dtype}|"
                          f"{hashlib.md5(images).hexdigest()}".encode())
        path = os.path.join(disk, f"{tag.hexdigest()}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                raw = z["data"]
            return ((raw.astype(np.uint32) << 16).view(np.float32) if bf16
                    else raw)
        host = np.ascontiguousarray(build_fn(images, bf16=bf16), np.float32)
        np.savez(path, data=((host.view(np.uint32) >> 16).astype(np.uint16)
                             if bf16 else host))
        return host

    return packed


def child(scene_name: str, device: str, grass: int, rocks: int,
          disk: str) -> dict:
    """Build ``scene_name`` ``BUILDS`` times in this process, with a disk
    tier in ``disk`` when it is not blank."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from zeldaengine_tpu_torch.scene import scenebuild as sb
    from zeldaengine_tpu_torch.scene.assets import build_scene_from_world
    from zeldaengine_tpu_torch.scene.demo import (
        build_demo_scene, build_textured_demo_scene)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    build_demo_scene(cs.TEST_CONFIG, grass=10, rocks=2, device=device)
    sync()
    state = {"atlas_s": 0.0, "packed": 0}
    inner = sb.cached_atlas

    def timed_atlas(kind, images, build_fn, bf16, dev):
        def counted(*a, **kw):
            state["packed"] += 1
            return build_fn(*a, **kw)

        if disk:
            images = np.ascontiguousarray(images)
            inner_fn = disk_tier(os.path.join(disk, kind), counted)
            os.makedirs(os.path.join(disk, kind), exist_ok=True)
        else:
            inner_fn = counted

        t0 = time.perf_counter()
        out = inner(kind, images, inner_fn, bf16, dev)
        sync()
        state["atlas_s"] += time.perf_counter() - t0
        return out

    sb.cached_atlas = timed_atlas
    builds = []
    for _ in range(BUILDS):
        state.update(atlas_s=0.0, packed=0)
        t0 = time.perf_counter()
        if scene_name == "config3t":
            build_textured_demo_scene(cs.config3(), grass=grass, rocks=rocks,
                                      device=device)
        else:
            build_scene_from_world(cs.config5_world(), cs.config5(),
                                   device=device)
        sync()
        builds.append(dict(build_s=time.perf_counter() - t0,
                           atlas_s=state["atlas_s"],
                           packed=state["packed"]))
    return dict(scene=scene_name, builds=builds)


def run(scene_name: str, setting: str, disk: str, args) -> dict:
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", scene_name,
         "--device", args.device, "--grass", str(args.grass), "--rocks",
         str(args.rocks), "--disk", disk], capture_output=True, text=True,
        check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["setting"] = setting
    return out


def main(args) -> None:
    device = args.device
    rows = []
    for scene_name in SCENES:
        for _ in range(2):
            d = tempfile.mkdtemp(prefix="atlas-cache-")
            for setting, disk in (("off", ""), ("disk_cold", d),
                                  ("disk_warm", d)):
                row = run(scene_name, setting, disk, args)
                print(json.dumps(row), flush=True)
                rows.append(row)
            shutil.rmtree(d, ignore_errors=True)
    summary = {}
    for scene_name in SCENES:
        for setting in ("off", "disk_cold", "disk_warm"):
            rs = [r for r in rows
                  if r["scene"] == scene_name and r["setting"] == setting]
            for i in range(BUILDS):
                for k in ("build_s", "atlas_s", "packed"):
                    summary[f"{scene_name}/{setting}/build{i + 1}/{k}"] = (
                        statistics.median(r["builds"][i][k] for r in rs))
    card = "cpu"
    if device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(dict(summary=summary, card=card)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, summary=summary, card=card), f,
                      indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grass", type=int, default=10000,
                    help="config 3t's grass instances (bench: 10000)")
    ap.add_argument("--rocks", type=int, default=65,
                    help="config 3t's rocks (bench: 65)")
    ap.add_argument("--child", default="")
    ap.add_argument("--disk", default="")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.device, args.grass,
                               args.rocks, args.disk)), flush=True)
    else:
        main(args)
