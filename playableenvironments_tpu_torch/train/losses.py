"""The phase-2 losses.

Port of the phase-2 losses of playableenvironments_tpu/train/losses.py
(masked means instead of boolean filtering; images in [0, 1]).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor], eps: float = 1e-8) -> torch.Tensor:
    """Mean over the elements where `mask` (broadcast against values) is True."""
    if mask is None:
        return values.mean()
    mask = mask.expand(values.shape).to(values.dtype)
    return (values * mask).sum() / (mask.sum() + eps)


def reconstruction_loss(observations: torch.Tensor, reconstructed: torch.Tensor) -> torch.Tensor:
    """MSE between observations and reconstructions."""
    return torch.mean((observations - reconstructed) ** 2)


def ray_object_distance_loss(
    observations: torch.Tensor, reconstructed: torch.Tensor, ray_object_distances: torch.Tensor
) -> torch.Tensor:
    """Reconstruction-error-weighted ray-to-object-center distances.

    :param observations, reconstructed: (..., 3); ray_object_distances (..., objects).
    """
    error = torch.sum((observations - reconstructed) ** 2, dim=-1)
    return torch.mean(error[..., None] * ray_object_distances)


def bounding_box_distance_loss(
    bounding_boxes: torch.Tensor, reconstructed_boxes: torch.Tensor, validity: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared box distance over valid detections.

    :param bounding_boxes, reconstructed_boxes: (..., objects, 4); validity (..., objects).
    :return: (scalar mean, (objects,) per-object means).
    """
    sq = torch.sum((bounding_boxes - reconstructed_boxes) ** 2, dim=-1)
    mask = validity.to(sq.dtype)
    dims = tuple(range(sq.dim() - 1))
    per_object = (sq * mask).sum(dim=dims) / (mask.sum(dim=dims) + 1e-8)
    return per_object.mean(), per_object


def opacity_loss(opacity: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """Mean |opacity| over rays of present objects: (..., rays), (...)."""
    return masked_mean(torch.abs(opacity), validity[..., None])


def attention_loss(attention: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """Mean attention over present objects: (..., h, w, 1), (...)."""
    return masked_mean(attention, validity[..., None, None, None])


def sharpness_loss(opacity: torch.Tensor, validity: torch.Tensor, mean: float = 0.5, std: float = 0.15) -> torch.Tensor:
    """Gaussian density around `mean`, pushing opacities toward 0 or 1."""
    var = std ** 2
    density = torch.exp(-((opacity - mean) ** 2) / (2 * var)) / math.sqrt(2 * math.pi * var)
    return masked_mean(density, validity[..., None])
