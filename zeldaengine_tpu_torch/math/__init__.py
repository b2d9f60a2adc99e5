from zeldaengine_tpu_torch.math.transforms import (
    look_at,
    perspective,
    perspective_vk,
    rotate_z,
    quat_to_mat4,
    transform_matrix,
    make_rot_matrix,
    euler_instance_matrix,
)
from zeldaengine_tpu_torch.math.color import hue2rgb, gamma_correct

__all__ = [
    "look_at",
    "perspective",
    "perspective_vk",
    "rotate_z",
    "quat_to_mat4",
    "transform_matrix",
    "make_rot_matrix",
    "euler_instance_matrix",
    "hue2rgb",
    "gamma_correct",
]
