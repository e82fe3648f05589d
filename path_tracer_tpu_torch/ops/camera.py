"""Camera ray generation: pinhole, thin-lens, 360 spherical.

Port of path_tracer_tpu/ops/camera.py (GenerateCameraRay,
scene.glsl.inc:613-655). Rays are channels-first (3, N); the camera
model is a Python int per render config.
"""

from __future__ import annotations

import torch

from ..core.constants import (
    CAMERA_MODEL_360,
    CAMERA_MODEL_PINHOLE,
    CAMERA_MODEL_THIN_LENS,
    PI,
    TAU,
)
from ..core.sampling import Rng, random_point_on_disk
from ..core.vec import normalize, transform_vector, vec3


def generate_camera_rays(packed, camera_index: int, camera_model: int,
                         ndc, rng: Rng):
    """World-space camera rays for normalized sample positions.

    ndc: (2, N) in [0, 1]^2. Returns (origin (3, N), unit direction (3, N)).
    """
    sensor_size = packed.camera_sensor_size[camera_index]
    sensor_distance = packed.camera_sensor_distance[camera_index]
    aperture = packed.camera_aperture_radius[camera_index]
    focal = packed.camera_focal_length[camera_index]
    world = packed.camera_world_from_camera[camera_index]

    zeros = torch.zeros_like(ndc[0])
    if camera_model in (CAMERA_MODEL_PINHOLE, CAMERA_MODEL_THIN_LENS):
        sensor_pos = vec3(
            -sensor_size[0] * (ndc[0] - 0.5),
            -sensor_size[1] * (0.5 - ndc[1]),
            sensor_distance.expand_as(zeros),
        )
        disk = random_point_on_disk(rng) * aperture
        origin = vec3(disk[0], disk[1], zeros)
        if camera_model == CAMERA_MODEL_PINHOLE:
            direction = normalize(origin - sensor_pos)
        else:
            # Thin lens: aim at the in-focus object point conjugate to the
            # sensor position (scene.glsl.inc:640-643).
            object_pos = -sensor_pos * (focal / (sensor_pos[2] - focal))
            direction = normalize(object_pos - origin)
    elif camera_model == CAMERA_MODEL_360:
        phi = (ndc[0] - 0.5) * TAU
        theta = (0.5 - ndc[1]) * PI
        origin = vec3(zeros, zeros, zeros)
        direction = vec3(torch.cos(theta) * torch.sin(phi),
                         torch.sin(theta),
                         -torch.cos(theta) * torch.cos(phi))
    else:
        raise ValueError(f'unknown camera model {camera_model}')

    origin_w = transform_vector(world, origin) + world[:3, 3][:, None]
    direction_w = normalize(transform_vector(world, direction))
    return origin_w, direction_w
