"""TCP livelink server — protocol-compatible with XkSocketListener
(ZeldaEngine.cpp:967-988, listener thread :1616-1710).

Same wire format: a client connects to port 8080 and sends one JSON world
description (schema of XkWorld::Load); the engine swaps in the new scene on
the next frame. Differences from the reference (deliberate fixes):

- cross-platform (the reference is Winsock-only; non-Windows is a TODO stub
  :1706-1708)
- thread-safe hand-off via a lock + queue instead of the reference's
  unsynchronized shared string/flag data race (:1683-1688 vs :1943)
- bad JSON is rejected without killing the render loop
- editor commands: a JSON object with a "Command" key is dispatched to
  ``on_command`` and its JSON reply is written back on the connection
  (the headless ImGui-editor surface, livelink/editor.py); anything else
  is treated as a world push, exactly like the reference
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Callable, Optional

LOG = logging.getLogger("zeldaengine.livelink")

RECV_BUFFER = 65720  # matches the reference's buffer size (:1054, :1678)


class LivelinkServer:
    """Background TCP listener; latest received world JSON wins."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 on_command: Optional[Callable[[dict], dict]] = None):
        self.host = host
        self.port = port
        self.on_command = on_command
        self._lock = threading.Lock()
        self._pending: Optional[str] = None
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        # Port 0 binds a free port; report the one bound.
        self.port = self._sock.getsockname()[1]
        self._sock.listen(1)
        self._sock.settimeout(0.5)
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        LOG.info("[Socket] listening on %s:%d", self.host, self.port)

    def _serve(self) -> None:
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with conn:
                LOG.info("[Socket] connection from %s", addr)
                chunks = []
                parsed = None
                conn.settimeout(2.0)
                try:
                    while True:
                        data = conn.recv(RECV_BUFFER)
                        if not data:
                            break
                        chunks.append(data)
                        # Stop as soon as the accumulated payload is a
                        # complete JSON document (keeps command latency low
                        # and supports worlds larger than one recv — the
                        # reference caps at a single 65,720 B read).
                        try:
                            parsed = json.loads(
                                b"".join(chunks).decode("utf-8")
                            )
                            break
                        except ValueError:
                            continue
                except socket.timeout:
                    pass
                raw = b"".join(chunks).decode("utf-8", errors="replace")
                if (
                    isinstance(parsed, dict)
                    and "Command" in parsed
                    and self.on_command is not None
                ):
                    try:
                        reply = self.on_command(parsed)
                    except Exception as e:  # noqa: BLE001
                        LOG.exception("[Socket] command failed")
                        reply = {"Status": "error", "Error": str(e)}
                    try:
                        conn.sendall(json.dumps(reply).encode("utf-8"))
                    except OSError:
                        LOG.warning("[Socket] reply send failed")
                elif raw:
                    with self._lock:
                        self._pending = raw

    def poll(self) -> Optional[str]:
        """Fetch-and-clear the most recent world JSON (render-loop side —
        the safe analogue of checking bReloadScene)."""
        with self._lock:
            raw, self._pending = self._pending, None
        return raw

    def stop(self) -> None:
        self._running = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
