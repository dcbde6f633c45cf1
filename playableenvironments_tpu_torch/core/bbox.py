"""Axis-aligned bounding boxes as (3, 2) tensors of (low, high) per axis.

Port of playableenvironments_tpu/core/bbox.py (aabb_size, aabb_contains,
ray_aabb_bounds).
"""

from __future__ import annotations

from typing import Tuple

import torch


def aabb_size(box: torch.Tensor) -> torch.Tensor:
    """(..., 3, 2) box -> (..., 3) side sizes."""
    return box[..., 1] - box[..., 0]


def aabb_contains(box: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(...) mask of (..., 3) points inside the (3, 2) box, bounds inclusive."""
    above_low = torch.all(points >= box[..., 0], dim=-1)
    below_high = torch.all(points <= box[..., 1], dim=-1)
    return above_low & below_high


def ray_aabb_bounds(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    box: torch.Tensor,
    validity: torch.Tensor,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test: per-ray [z_near, z_far] of the box intersection.

    Keeps the reference's epsilon in the direction denominator and collapses
    missed or invalid rays to z_near = z_far = 0.

    :param ray_origins: (..., 3) object-frame origins.
    :param ray_directions: (..., rays, 3) object-frame directions.
    :param box: (3, 2) AABB.
    :param validity: (...) bool, False where the object is absent.
    :return: ((..., rays) z_near, (..., rays) z_far).
    """
    corners = torch.stack([box[:, 0], box[:, 1]], dim=0)  # (2, 3)
    rel = (corners - ray_origins[..., None, :])[..., None, :, :]
    t = rel / (ray_directions[..., None, :] + eps)

    t_low = torch.amin(t, dim=-2)
    t_high = torch.amax(t, dim=-2)
    z_near = torch.amax(t_low, dim=-1)
    z_far = torch.amin(t_high, dim=-1)

    invalid = (z_far <= z_near) | ~validity[..., None]
    zero = torch.zeros_like(z_near)
    return torch.where(invalid, zero, z_near), torch.where(invalid, zero, z_far)
