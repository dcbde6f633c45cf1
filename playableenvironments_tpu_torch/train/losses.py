"""The phase-1, phase-2 and phase-3 losses.

Port of the phase-2 losses of playableenvironments_tpu/train/losses.py
(masked means instead of boolean filtering; images in [0, 1]), the image
losses of the decoder path and of phase 1 (`image_reconstruction_loss`,
`spatial_kl_gaussian`) and its phase-3 losses: the Gaussian KL, the action
entropy, the EMA-smoothed mutual information, the GAN objectives and ACMV;
and phase 2's consistency losses (pose, keypoint, keypoint opacity).
"""

from __future__ import annotations

import math
import sys
from typing import Optional, Tuple

import torch

from playableenvironments_tpu_torch.core.transforms3d import rotation_x, rotation_y, rotation_z

EPS = sys.float_info.epsilon


def masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor], eps: float = 1e-8) -> torch.Tensor:
    """Mean over the elements where `mask` (broadcast against values) is True."""
    if mask is None:
        return values.mean()
    mask = mask.expand(values.shape).to(values.dtype)
    return (values * mask).sum() / (mask.sum() + eps)


def reconstruction_loss(observations: torch.Tensor, reconstructed: torch.Tensor) -> torch.Tensor:
    """MSE between observations and reconstructions."""
    return torch.mean((observations - reconstructed) ** 2)


def radial_weight_mask(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W) weights: 1 at the centre fading to 0 at the border
    (Chebyshev distance)."""
    rows = torch.abs(torch.arange(height, dtype=dtype, device=device) - (height - 1) / 2.0)[:, None]
    cols = torch.abs(torch.arange(width, dtype=dtype, device=device) - (width - 1) / 2.0)[None, :]
    distances = torch.maximum(rows, cols)
    lo, hi = distances.min(), distances.max()
    return 1.0 - (distances - lo) / (hi - lo)


def image_reconstruction_loss(
    observations: torch.Tensor, reconstructed: torch.Tensor, use_radial_weights: bool = False
) -> torch.Tensor:
    """Pixel MSE over (..., H, W, C) images, optionally centre-weighted."""
    loss = (observations - reconstructed) ** 2
    if use_radial_weights:
        h, w = observations.shape[-3], observations.shape[-2]
        mask = radial_weight_mask(h, w, loss.dtype, loss.device)[..., None]
        loss = torch.sum(loss * mask, dim=(-3, -2)) / torch.sum(mask, dim=(-3, -2))
    return loss.mean()


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


def kl_gaussian(distribution_parameters: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) for (..., 2, dim) (mean, log variance) stacks."""
    mean = distribution_parameters[..., 0, :]
    log_variance = distribution_parameters[..., 1, :]
    kl = 1.0 + log_variance - mean ** 2 - torch.exp(log_variance)
    return -0.5 * torch.mean(torch.sum(kl, dim=-1))


def spatial_kl_gaussian(distribution_parameters: torch.Tensor) -> torch.Tensor:
    """KL to N(0, I) of spatial latents (..., H, W, 2F): the first half of
    the channels is the mean, the second the log variance. Computed in f32
    whatever the latents' dtype."""
    distribution_parameters = distribution_parameters.to(torch.float32)
    features = distribution_parameters.shape[-1] // 2
    mean = distribution_parameters[..., :features]
    log_variance = distribution_parameters[..., features:]
    kl = 1.0 + log_variance - mean ** 2 - torch.exp(log_variance)
    return -0.5 * torch.mean(torch.sum(kl, dim=-1))


def entropy_logits(logits: torch.Tensor) -> torch.Tensor:
    """Mean per-sample entropy of softmax(logits)."""
    log_p = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.sum(torch.exp(log_p) * log_p, dim=-1))


def joint_probability_matrix(distribution_1: torch.Tensor, distribution_2: torch.Tensor) -> torch.Tensor:
    """Symmetrized, normalized (dim, dim) joint probability of paired
    categorical samples."""
    dim = distribution_1.shape[-1]
    p = distribution_1.reshape(-1, dim).t() @ distribution_2.reshape(-1, dim)
    p = (p + p.t()) / 2.0
    return p / p.sum()


def mutual_information_loss(
    distribution_1: torch.Tensor,
    distribution_2: torch.Tensor,
    lamb: float = 1.0,
    smoothing_matrix: Optional[torch.Tensor] = None,
    smoothing_alpha: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Negative mutual information of the (optionally EMA-smoothed) joint
    probability matrix: (loss, the smoothed matrix to carry, detached)."""
    p = joint_probability_matrix(distribution_1, distribution_2)
    if smoothing_matrix is not None:
        p = smoothing_matrix * (1.0 - smoothing_alpha) + p * smoothing_alpha
    new_matrix = p.detach()
    p = torch.clamp(p, min=EPS)
    marginal_rows = torch.clamp(p.sum(dim=1, keepdim=True), min=EPS)
    marginal_cols = torch.clamp(p.sum(dim=0, keepdim=True), min=EPS)
    mi = p * (torch.log(p) - lamb * torch.log(marginal_rows) - lamb * torch.log(marginal_cols))
    return -mi.sum(), new_matrix


def pose_consistency_loss(previous_expected_positions: torch.Tensor, next_expected_positions: torch.Tensor,
                          both_valid: torch.Tensor) -> torch.Tensor:
    """MSE between the expected surface positions of consecutive frames
    matched through the optical flow, over the pairs where the object is in
    both. positions (..., T-1, C, n, 3); both_valid (..., T-1, C)."""
    sq = (previous_expected_positions - next_expected_positions) ** 2
    return masked_mean(sq, both_valid[..., None, None])


def keypoint_consistency_loss(expected_positions: torch.Tensor, confidence: torch.Tensor,
                              confidence_threshold: float) -> torch.Tensor:
    """MSE over every pair of observations of the keypoint-anchored expected
    positions, over the pairs whose confidences both reach the threshold
    (>=). expected_positions (B, T, C, n, 3); confidence (B, T, C, n)."""
    sq = (expected_positions[:, :, None] - expected_positions[:, None, :]) ** 2
    valid = (confidence[:, :, None] >= confidence_threshold) & (confidence[:, None, :] >= confidence_threshold)
    return masked_mean(sq, valid[..., None])


def keypoint_opacity_loss(opacity: torch.Tensor, confidence: torch.Tensor, confidence_threshold: float) -> torch.Tensor:
    """(1 - opacity)^2 where the keypoint's confidence exceeds the threshold
    (>): rays through keypoints should hit the object."""
    return masked_mean((1.0 - opacity) ** 2, confidence > confidence_threshold)


def gan_loss(prediction: torch.Tensor, target_is_real: bool, mode: str = "lsgan") -> torch.Tensor:
    """LSGAN or vanilla (BCE with logits) GAN objective."""
    target = 1.0 if target_is_real else 0.0
    if mode == "lsgan":
        return torch.mean((prediction - target) ** 2)
    if mode == "vanilla":
        return torch.mean(torch.clamp(prediction, min=0.0) - prediction * target
                          + torch.log1p(torch.exp(-prediction.abs())))
    raise ValueError(f"unknown gan mode {mode}")


def camera_relative_movements(movements: torch.Tensor, camera_rotations: torch.Tensor, rotation_axis: int) -> torch.Tensor:
    """World-frame movements (bs, T-1, 3) relative to the camera: the
    camera's rotation about the ground-normal axis undone (its tilt is not
    applied). camera_rotations (bs, T, 1, 3): exactly one camera."""
    if camera_rotations.shape[-2] != 1:
        raise ValueError(f"camera-relative ACMV needs a single camera, got {camera_rotations.shape[-2]}")
    if rotation_axis is None:
        raise ValueError("camera-relative ACMV requires acmv_rotation_axis")
    angles = -camera_rotations[:, :-1, 0, rotation_axis]
    matrices = (rotation_x, rotation_y, rotation_z)[rotation_axis](angles)
    return torch.einsum("btij,btj->bti", matrices, movements)


def acmv_loss(movements: torch.Tensor, actions: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Action-Conditioned Movement Variance: within-action movement variance
    over total movement variance. movements (..., dim); actions (...,
    actions_count) probabilities."""
    m = movements.reshape(-1, movements.shape[-1])
    a = actions.reshape(-1, actions.shape[-1])
    n = m.shape[0]
    action_mass = a.sum(dim=0)[:, None]
    action_means = (a.t() @ m) / (action_mass + eps)
    sq = (m[:, None, :] - action_means[None]) ** 2
    numerator = torch.mean(torch.sum(sq * a[..., None], dim=(0, 1))) / n
    denominator = torch.mean(m.var(dim=0, unbiased=False))
    return numerator / (denominator + eps)
