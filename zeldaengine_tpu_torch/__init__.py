"""ZeldaEngine on PyTorch + CUDA: a software-rasterizing deferred-PBR
renderer for one NVIDIA Hopper card.

Same sub-package layout as the JAX package beside it (``math/ scene/ ops/
passes/ meshlet/ livelink/ parallel/ tools/ utils/``), so each module's
counterpart is found by path. Plain
tensor math is PyTorch; the rasterizer, the PCF filter and the sky tap are
CUDA C++ kernels under ``csrc/``, built with nvcc at first use
(``ops/_build.py``) and bound through ctypes.

Device rule: entry points (``build_demo_scene``, ``build_view_state``,
``engine``) default to ``device="cuda"`` and raise when no card is
present; ops dispatch on the device of the tensors they are given (CUDA
tensor -> kernel, CPU tensor -> plain PyTorch version).
"""

import torch as _torch

# Every matrix product of the engine (transform composition, the sky-ray
# unprojection) needs full fp32; state it once instead of per call.
_torch.backends.cuda.matmul.allow_tf32 = False

from zeldaengine_tpu_torch.config import EngineConfig, TEST_CONFIG  # noqa: E402

__all__ = ["EngineConfig", "TEST_CONFIG"]
