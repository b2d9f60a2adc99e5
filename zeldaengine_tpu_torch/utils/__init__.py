from zeldaengine_tpu_torch.utils.image import write_png, read_png, to_uint8
from zeldaengine_tpu_torch.utils.device import require_device

__all__ = ["write_png", "read_png", "to_uint8", "require_device"]
