"""Device resolution for the package's entry points."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """Resolve ``device``; a CUDA device that is not there raises.

    Entry points default to ``"cuda"``: a machine without a card must ask
    for ``device="cpu"`` explicitly (the tests do) rather than be served
    by the CPU silently.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "zeldaengine_tpu_torch: device='cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the host"
        )
    return dev
