"""Object pose (o2w rotation and translation) strategies.

Port of playableenvironments_tpu/models/parameter_encoders.py:
`static_object_poses` (constant poses at the range midpoints),
`classic_object_poses` (the ground intersection of the ray through each
box's bottom-center pixel) and the learned strategy
`ObjectParametersEncoderV4` (the Minecraft players: a CNN over each
object's crop regresses the yaw offset from the camera). Object axis before
the coordinate axis.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.config import ParameterEncoderConfig
from playableenvironments_tpu_torch.core.rays import transform_points
from playableenvironments_tpu_torch.core.transforms3d import invert_rigid
from playableenvironments_tpu_torch.models.layers import BatchNorm, ResidualBlock, conv
from playableenvironments_tpu_torch.ops.roi_crop import crop_and_resize, expand_boxes, roi_pool


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


def normalize_angle_range(angle: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Wrap angles into [low, high) in steps of (high - low) (a floored
    modulo, as jnp.mod)."""
    return torch.remainder(angle - low, high - low) + low


class ObjectParametersEncoderV4(nn.Module):
    """Learned yaw plus geometric translation. A CNN over each object's
    expanded crop (conv 7x7/2, BN, leaky ReLU 0.2, eight residual blocks to
    512 features, mean pool, `rotation_head`) gives tanh-bounded (cos, sin)
    components of the yaw offset from the camera; rotation = camera yaw +
    offset on `rotation_axis`. Translation = the ground intersection of the
    feet ray plus `edge_to_center_distance / cos(offset wrapped to
    [-pi/4, pi/4))` along the feet ray's unit ground direction. Both are 0
    for invalid boxes. Train mode uses batch statistics and updates the
    running ones (flax BatchNorm semantics, models.layers.BatchNorm)."""

    _BLOCKS = (("initial_0", 64, 64, 2), ("initial_1", 64, 64, 1),
               ("final_0", 64, 128, 2), ("final_1", 128, 128, 1),
               ("final_2", 128, 256, 2), ("final_3", 256, 256, 1),
               ("final_4", 256, 512, 2), ("final_5", 512, 512, 1))

    def __init__(self, cfg: ParameterEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = conv(3, 64, 7, stride=2, padding=3, device=device)
        self.bn1 = BatchNorm(64, device=device)
        for name, cin, cout, df in self._BLOCKS:
            self.add_module(name, ResidualBlock(cin, cout, df, device=device))
        self.rotation_head = nn.Linear(512, 2, device=device)

    def forward(
        self,
        observations: torch.Tensor,
        w2c_matrix: torch.Tensor,
        camera_rotations: torch.Tensor,
        focals: torch.Tensor,
        bounding_boxes: torch.Tensor,
        boxes_validity: torch.Tensor,
        train: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:param observations: (N, H, W, 3) first-camera frames;
        w2c_matrix (N, 4, 4); camera_rotations (N, 3); focals (N,) rescaled;
        bounding_boxes (N, objects, 4) normalized (l, t, r, b);
        boxes_validity (N, objects) bool.
        :return: ((N, objects, 3) o2w rotations, (N, objects, 3) translations).
        """
        cfg = self.cfg
        n, height, width, _ = observations.shape
        objects = bounding_boxes.shape[-2]
        boxes = expand_boxes(bounding_boxes, cfg.expansion_rows, cfg.expansion_cols)
        scale = torch.tensor([width, height, width, height], dtype=boxes.dtype, device=boxes.device)
        crop = roi_pool if cfg.crop_mode == "roi_pool" else crop_and_resize
        crops = crop(observations.repeat_interleave(objects, dim=0), (boxes * scale).reshape(-1, 4),
                     tuple(cfg.input_size))
        x = F.leaky_relu(self.bn1(self.conv1(crops.permute(0, 3, 1, 2)), train), 0.2)
        for name, *_ in self._BLOCKS:
            x = getattr(self, name)(x, train)
        # tanh * 1.4 keeps the cardinal rotations out of saturation.
        vec = torch.tanh(self.rotation_head(x.mean(dim=(2, 3)))) * 1.4
        yaw_offset = torch.atan2(vec[..., 1], vec[..., 0]).reshape(n, objects)

        axis = torch.arange(3, device=observations.device) == cfg.rotation_axis
        yaw = camera_rotations[..., cfg.rotation_axis][:, None] + yaw_offset
        rotations = torch.where(axis, yaw[..., None], 0.0)
        rotations = torch.where(boxes_validity[..., None], rotations, 0.0)

        translations, directions = _ground_intersection(
            w2c_matrix, focals, bounding_boxes, (height, width), cfg.zero_axis
        )
        ground = torch.where(torch.arange(3, device=directions.device) == cfg.zero_axis, 0.0, directions)
        ground = ground / torch.linalg.norm(ground, dim=-1, keepdim=True)
        wrapped = normalize_angle_range(yaw_offset, -math.pi / 4, math.pi / 4)
        sloped = cfg.edge_to_center_distance / torch.cos(wrapped)
        translations = torch.where(boxes_validity[..., None], translations + ground * sloped[..., None], 0.0)
        return rotations, translations
