"""The livelink's wire format, as a tool pushing worlds speaks it: one TCP
connection a world, the world's JSON document as UTF-8, then close
(ZeldaPython/ZeldaUntitled.py:12-26, ``sendDataToEngine``). A copy kept
with the benchmark, so that the pushes do not depend on the program's
client."""

from __future__ import annotations

import socket
import threading
import time


def send_world(payload: bytes, port: int, host: str = "127.0.0.1") -> None:
    with socket.create_connection((host, port), timeout=5.0) as s:
        s.sendall(payload)


class Pusher:
    """A thread that pushes ``payloads[i]`` at ``interval`` seconds from its
    start, i = 0, 1, ... until it is stopped or has sent them all; ``sent``
    counts the pushes completed, ``error`` holds a failed one's error."""

    def __init__(self, payloads: list, interval: float, port: int):
        self.payloads = payloads
        self.interval = interval
        self.port = port
        self.sent = 0
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="frame_bench.pusher")

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        due = time.monotonic()
        for payload in self.payloads:
            if self._stop.is_set():
                return
            try:
                send_world(payload, self.port)
            except OSError as e:
                self.error = e
                return
            self.sent += 1
            due += self.interval
            self._stop.wait(max(0.0, due - time.monotonic()))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("the pusher thread did not stop")
