from zeldaengine_tpu_torch.scene.world import (
    World,
    CameraDesc,
    LightDesc,
    ObjectDesc,
    RenderFlags,
    make_demo_world,
)
from zeldaengine_tpu_torch.scene.mesh import (
    Mesh, load_obj, make_cube, make_sphere, make_plane)
from zeldaengine_tpu_torch.scene.scenebuild import (
    GpuScene, SceneMeta, SceneBuilder)
from zeldaengine_tpu_torch.scene.demo import (
    build_demo_scene, build_textured_demo_scene, demo_world)

__all__ = [
    "World", "CameraDesc", "LightDesc", "ObjectDesc", "RenderFlags",
    "make_demo_world", "Mesh", "load_obj", "make_cube", "make_sphere",
    "make_plane", "GpuScene", "SceneMeta", "SceneBuilder",
    "build_demo_scene", "build_textured_demo_scene", "demo_world",
]
