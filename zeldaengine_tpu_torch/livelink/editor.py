"""Headless editor protocol — the ImGui editor surface as JSON-over-TCP.

The reference's editor (UpdateImGuiWidgets, ZeldaEngine.cpp:4324-4581) is an
outliner tree + details panel + menu bar (File New/Save/Reload, Run->Compile
Shaders) + an embedded "Python IDE" pane whose Run button is a stub (:4563).
Headless equivalent: structured JSON commands over the livelink socket —
a client sends ``{"Command": ...}`` and receives a JSON reply on the same
connection (plain world-JSON pushes still hot-reload the scene, unchanged).

Commands:
  GetOutliner                      the outliner tree (:4440-4536)
  GetDetails  {Target}             details panel for Camera / Engine /
                                   DirectionalLight/i / PointLight/i /
                                   SpotLight/i / Object/i
  SetDetails  {Target, Values}     edit; takes effect next frame (object
                                   edits rebuild the scene like the
                                   reference's bReloadScene path)
  GetStats                         FrameStats (the stats overlay)
  SaveWorld   {Path?}              File->Save (:4361)
  ReloadWorld {Path?}              File->Reload (:4365)
  NewWorld                         File->New (XkWorld::Reset)
  CompileShaders                   Run->Compile Shaders (:4384): replies
                                   with a Note; the port has nothing to
                                   recompile (eager frame, kernels built
                                   once per process)
  RunScript   {Source}             the Python IDE pane; actually executes
                                   (the reference's Run button does not)
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import logging
from typing import Optional

import numpy as np

LOG = logging.getLogger("zeldaengine.editor")


def _vec(v) -> list:
    return [float(x) for x in np.asarray(v).ravel()]


class EditorHandler:
    """Dispatches editor commands against a live Engine."""

    def __init__(self, engine):
        self.engine = engine

    def handle(self, msg: dict) -> dict:
        cmd = msg.get("Command", "")
        fn = getattr(self, f"_cmd_{cmd.lower()}", None)
        if fn is None:
            return {"Status": "error", "Error": f"unknown command {cmd!r}"}
        try:
            with self.engine.lock:
                out = fn(msg)
            out.setdefault("Status", "ok")
            return out
        except Exception as e:  # noqa: BLE001 — protocol must not crash
            LOG.exception("[EDITOR] command %s failed", cmd)
            return {"Status": "error", "Error": f"{type(e).__name__}: {e}"}

    # ----------------------------------------------------------- outliner

    def _cmd_getoutliner(self, msg: dict) -> dict:
        w = self.engine.world
        meta = self.engine.meta
        objects = [
            {
                "Index": i,
                "ProfabName": o.profab_name,
                "RenderFlags": int(o.render_flags),
                "InstanceCount": int(o.instance_count),
            }
            for i, o in enumerate(w.object_descs)
        ]
        return {
            "Camera": {"Position": _vec(w.main_camera.position)},
            "Skydome": {"Enabled": bool(w.enable_skydome)},
            "Background": {"Enabled": bool(w.enable_background)},
            "Lights": {
                "Directional": len(w.directional_lights),
                "Point": len(w.point_lights),
                "Spot": len(w.spot_lights),
            },
            "Objects": objects,
            "SceneTriangles": int(meta.num_triangles) if meta else 0,
            "SceneInstances": int(meta.num_instances) if meta else 0,
        }

    # ------------------------------------------------------------ details

    def _resolve_target(self, target: str):
        w = self.engine.world
        if target in ("Camera", "MainCamera"):
            return w.main_camera
        if target == "Engine":
            return self.engine
        kind, _, idx = target.partition("/")
        lists = {
            "DirectionalLight": w.directional_lights,
            "PointLight": w.point_lights,
            "SpotLight": w.spot_lights,
            "Object": w.object_descs,
        }
        if kind in lists:
            return lists[kind][int(idx)]
        raise KeyError(f"unknown target {target!r}")

    def _cmd_getdetails(self, msg: dict) -> dict:
        target = self._resolve_target(msg.get("Target", "Camera"))
        if target is self.engine:
            e = self.engine
            return {
                "Values": {
                    "DebugView": e.debug_view,
                    "GameMode": e.game_mode,
                    "PlayStageRoll": e.play_stage_roll,
                    "PlayLightRoll": e.play_light_roll,
                    "MaterialOverrides": _vec(e.material_overrides),
                }
            }
        vals = {}
        for f in dataclasses.fields(target):
            v = getattr(target, f.name)
            vals[f.name] = _vec(v) if isinstance(v, np.ndarray) else (
                v if isinstance(v, (int, float, bool, str)) else str(v)
            )
        return {"Values": vals}

    def _cmd_setdetails(self, msg: dict) -> dict:
        name = msg.get("Target", "Camera")
        target = self._resolve_target(name)
        values = msg.get("Values", {})
        if target is self.engine:
            e = self.engine
            if "DebugView" in values:
                e.set_debug_view(int(values["DebugView"]))
            if "GameMode" in values:
                e.game_mode = bool(values["GameMode"])
            if "PlayStageRoll" in values:
                e.play_stage_roll = bool(values["PlayStageRoll"])
            if "PlayLightRoll" in values:
                e.play_light_roll = bool(values["PlayLightRoll"])
            if "MaterialOverrides" in values:
                e.material_overrides = np.asarray(
                    values["MaterialOverrides"], np.float32
                )
            return {}
        applied = []
        for f in dataclasses.fields(target):
            if f.name not in values:
                continue
            cur = getattr(target, f.name)
            new = values[f.name]
            if isinstance(cur, np.ndarray):
                new = np.asarray(new, cur.dtype)
            else:
                new = type(cur)(new)
            setattr(target, f.name, new)
            applied.append(f.name)
        # Object-desc edits change scene geometry -> rebuild (the analogue
        # of bReloadScene, ZeldaEngine.cpp:1943-1951). Light/camera edits
        # flow through the per-frame ViewState with no rebuild.
        if name.startswith("Object"):
            self.engine.request_rebuild()
        return {"Applied": applied}

    # -------------------------------------------------------------- stats

    def _cmd_getstats(self, msg: dict) -> dict:
        return {"Stats": dataclasses.asdict(self.engine.stats)}

    # ---------------------------------------------------------- file menu

    def _cmd_saveworld(self, msg: dict) -> dict:
        path = msg.get("Path") or self.engine.world.file_path
        self.engine.world.save(path)
        return {"Path": path}

    def _cmd_reloadworld(self, msg: dict) -> dict:
        path = msg.get("Path")
        if path:
            self.engine.world.file_path = path
        self.engine.world.load()
        self.engine.request_rebuild()
        return {"Path": self.engine.world.file_path}

    def _cmd_newworld(self, msg: dict) -> dict:
        self.engine.world.reset()
        self.engine.request_rebuild()
        return {}

    # ----------------------------------------------------------- run menu

    def _cmd_compileshaders(self, msg: dict) -> dict:
        """The port has no per-config compiled executables: the frame is
        eager PyTorch, and the CUDA kernels are built once per process
        from ``csrc/`` (``ops/_build.py``). Nothing is unloaded or
        rebuilt here, because a frame may be in flight on the card."""
        return {"Note": "nothing to recompile: the frame is eager and its "
                        "kernels are built once per process"}

    def _cmd_runscript(self, msg: dict) -> dict:
        """The 'Python IDE' pane. The livelink socket is a local developer
        tool (same trust model as the reference's editor), so the script
        runs with full access to the engine object."""
        source = msg.get("Source", "")
        ns = {"engine": self.engine, "world": self.engine.world, "np": np}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            exec(source, ns)  # noqa: S102 — editor feature by design
        return {"Output": buf.getvalue()}
