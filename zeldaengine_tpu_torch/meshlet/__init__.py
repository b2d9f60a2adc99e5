from zeldaengine_tpu_torch.meshlet.build import (
    Meshlet, MeshletSet, build_meshlets)
from zeldaengine_tpu_torch.meshlet.io import load_meshlet_set, save_meshlet_set

__all__ = [
    "build_meshlets",
    "MeshletSet",
    "Meshlet",
    "save_meshlet_set",
    "load_meshlet_set",
]
