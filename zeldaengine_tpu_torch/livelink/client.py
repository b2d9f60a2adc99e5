"""Livelink client — sendDataToEngine (ZeldaPython/ZeldaUntitled.py:12-26)."""

from __future__ import annotations

import json
import socket
from typing import Union


def send_data_to_engine(data: Union[str, dict], host: str = "127.0.0.1",
                        port: int = 8080) -> None:
    if isinstance(data, dict):
        data = json.dumps(data)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.connect((host, port))
        s.sendall(data.encode("utf-8"))


def editor_request(command: dict, host: str = "127.0.0.1",
                   port: int = 8080, timeout: float = 10.0) -> dict:
    """Send one editor-protocol command (livelink/editor.py) and return
    the engine's JSON reply."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect((host, port))
        s.sendall(json.dumps(command).encode("utf-8"))
        s.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            data = s.recv(65536)
            if not data:
                break
            chunks.append(data)
    return json.loads(b"".join(chunks).decode("utf-8"))
