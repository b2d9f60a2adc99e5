from zeldaengine_tpu_torch.passes.view import ViewState, build_view_state
from zeldaengine_tpu_torch.passes.frame import render_frame

__all__ = ["ViewState", "build_view_state", "render_frame"]
