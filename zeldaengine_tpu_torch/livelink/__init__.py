from zeldaengine_tpu_torch.livelink.server import LivelinkServer
from zeldaengine_tpu_torch.livelink.client import (
    editor_request,
    send_data_to_engine,
)
from zeldaengine_tpu_torch.livelink.editor import EditorHandler

__all__ = [
    "LivelinkServer",
    "send_data_to_engine",
    "editor_request",
    "EditorHandler",
]
