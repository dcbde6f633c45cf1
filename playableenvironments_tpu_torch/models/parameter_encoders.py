"""Object pose (o2w rotation and translation) strategies.

Port of the pure-function strategies of
playableenvironments_tpu/models/parameter_encoders.py: `static_object_poses`
(constant poses at the range midpoints) and `classic_object_poses` (the
ground intersection of the ray through each box's bottom-center pixel).
The learned strategy (ObjectParametersEncoderV4, the Minecraft players) is
not ported yet. Object axis before the coordinate axis.
"""

from __future__ import annotations

from typing import Tuple

import torch

from playableenvironments_tpu_torch.config import ParameterEncoderConfig
from playableenvironments_tpu_torch.core.rays import transform_points
from playableenvironments_tpu_torch.core.transforms3d import invert_rigid


def static_object_poses(
    cfg: ParameterEncoderConfig, batch_shape: Tuple[int, ...], device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((*batch, objects, 3) rotations, (*batch, objects, 3) translations)."""
    rot_range = torch.tensor(cfg.rotation_range, dtype=torch.float32, device=device)
    trans_range = torch.tensor(cfg.translation_range, dtype=torch.float32, device=device)
    rotations = (rot_range[..., 0] + rot_range[..., 1]) / 2.0
    translations = (trans_range[..., 0] + trans_range[..., 1]) / 2.0
    return (rotations.expand(tuple(batch_shape) + rotations.shape),
            translations.expand(tuple(batch_shape) + translations.shape))


def _ground_intersection(
    w2c_matrix: torch.Tensor,
    focals: torch.Tensor,
    boxes: torch.Tensor,
    image_size: Tuple[int, int],
    zero_axis: int,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intersect the ray through each box's bottom-center pixel with the
    plane where axis `zero_axis` is 0.

    :param w2c_matrix: (..., 4, 4); focals (...); boxes (..., objects, 4)
        normalized (l, t, r, b).
    :return: ((..., objects, 3) ground positions, (..., objects, 3) world
        directions through the feet pixel).
    """
    height, width = image_size
    c2w = invert_rigid(w2c_matrix)
    feet_x = (boxes[..., 0] + boxes[..., 2]) / 2.0 * width - width / 2.0
    feet_y = -(boxes[..., 3] * height - height / 2.0)
    feet_z = -focals[..., None].expand(feet_x.shape)
    directions_cam = torch.stack([feet_x, feet_y, feet_z], dim=-1)
    origins = c2w[..., :3, 3][..., None, :].expand(directions_cam.shape)
    directions = transform_points(directions_cam, c2w[..., None, :, :], translate=False)
    n = -origins[..., zero_axis] / (directions[..., zero_axis] + eps)
    positions = origins + n[..., None] * directions
    axis = torch.arange(3, device=positions.device) == zero_axis
    return torch.where(axis, 0.0, positions), directions


def classic_object_poses(
    cfg: ParameterEncoderConfig,
    w2c_matrix: torch.Tensor,
    focals: torch.Tensor,
    bounding_boxes: torch.Tensor,
    boxes_validity: torch.Tensor,
    image_size: Tuple[int, int],
    apply_ranges: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground intersection of the feet ray (first camera), shifted by the
    range midpoint along `zero_axis`; rotation at the range midpoint; 0 for
    invalid boxes.

    :return: ((..., objects, 3) rotations, (..., objects, 3) translations).
    """
    translations, _ = _ground_intersection(w2c_matrix, focals, bounding_boxes, image_size, cfg.zero_axis)
    if apply_ranges:
        trans_range = torch.tensor(cfg.translation_range, dtype=translations.dtype, device=translations.device)
        offset = (trans_range[:, cfg.zero_axis, 0] + trans_range[:, cfg.zero_axis, 1]) / 2.0
        axis = (torch.arange(3, device=translations.device) == cfg.zero_axis).to(translations.dtype)
        translations = translations + offset[:, None] * axis
        rot_range = torch.tensor(cfg.rotation_range, dtype=translations.dtype, device=translations.device)
        rotations_value = (rot_range[..., 0] + rot_range[..., 1]) / 2.0
    else:
        rotations_value = torch.zeros((len(cfg.translation_range), 3), dtype=translations.dtype,
                                      device=translations.device)
    translations = torch.where(boxes_validity[..., None], translations, 0.0)
    return rotations_value.expand(translations.shape), translations
