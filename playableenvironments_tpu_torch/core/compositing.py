"""Volume-rendering integration and sort-free multi-object composition.

Port of playableenvironments_tpu/core/compositing.py: `position_distances`,
`alphas_from_raw`, `compositing_weights`, `integrate` and
`compose_integrate_sortfree`. Where the JAX functions draw noise from a key,
these take the noise tensor itself (`noise`, a unit normal draw of the raw
alphas' shape, or None without perturbation).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

# No-successor fill for the sort-free successor minimum, and the distance of
# the last sample.
BIG = 3.0e38
LAST_DISTANCE = 1e10


def position_distances(ray_positions_t: torch.Tensor, ray_directions: torch.Tensor) -> torch.Tensor:
    """Distance from each sample to the next, scaled by the direction norm;
    the last one is 1e10.

    :param ray_positions_t: (..., rays, positions); ray_directions (..., rays, 3).
    """
    deltas = ray_positions_t[..., 1:] - ray_positions_t[..., :-1]
    last = torch.full_like(ray_positions_t[..., :1], LAST_DISTANCE)
    distances = torch.cat([deltas, last], dim=-1)
    return distances * torch.linalg.norm(ray_directions, dim=-1)[..., None]


def alphas_from_raw(
    raw_alphas: torch.Tensor, distances: torch.Tensor, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """alpha = 1 - exp(-relu(raw + noise) * distance)."""
    if noise is not None:
        raw_alphas = raw_alphas + noise
    return 1.0 - torch.exp(-torch.relu(raw_alphas) * distances)


def compositing_weights(alphas: torch.Tensor) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-10), an exclusive
    cumulative product over the last axis."""
    shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas[..., :-1] + 1e-10], dim=-1
    )
    return alphas * torch.cumprod(shifted, dim=-1)


def _disparity(depth: torch.Tensor, opacity: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(depth / torch.clamp(opacity, min=1e-10), min=1e-10)


def integrate(
    raw_features: torch.Tensor,
    raw_alphas: torch.Tensor,
    ray_directions: torch.Tensor,
    ray_positions_t: torch.Tensor,
    ray_displacements: torch.Tensor,
    ray_divergences: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Integrate one object's samples along each ray.

    :param raw_features: (..., rays, positions, F); raw_alphas, t and
        divergences (..., rays, positions); displacements (..., rays,
        positions, 3); ray_directions (..., rays, 3).
    :return: integrated_features (..., rays, F), opacity, weights, depth,
        disparity, integrated_displacements_magnitude, integrated_divergence.
    """
    distances = position_distances(ray_positions_t, ray_directions)
    alphas = alphas_from_raw(raw_alphas, distances, noise)
    weights = compositing_weights(alphas)
    depth = torch.sum(weights * ray_positions_t, dim=-1)
    opacity = torch.sum(weights, dim=-1)
    return {
        "integrated_features": torch.sum(weights[..., None] * raw_features, dim=-2),
        "opacity": opacity,
        "weights": weights,
        "depth": depth,
        "disparity": _disparity(depth, opacity),
        "integrated_displacements_magnitude": torch.mean(
            weights.detach() * torch.linalg.norm(ray_displacements, dim=-1), dim=-1
        ),
        "integrated_divergence": torch.mean(alphas.detach() * torch.abs(ray_divergences), dim=-1),
    }


def compose_integrate_sortfree(
    all_raw_features: Sequence[torch.Tensor],
    all_raw_alphas: Sequence[torch.Tensor],
    all_ray_positions_t: Sequence[torch.Tensor],
    ray_directions: torch.Tensor,
    all_ray_displacements: Optional[Sequence[torch.Tensor]] = None,
    all_ray_divergences: Optional[Sequence[torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Cross-object integration without a sort: each sample's successor is a
    masked minimum over all samples after it in (t, concatenation index)
    order, and its transmittance is its own object's exclusive prefix sum of
    log(1 - alpha) plus the other objects' mass strictly before it.

    :param noise: (..., rays, sum of positions) unit normal draws added to
        the concatenated raw alphas, or None.
    :return: integrate()-style dict; "weights" in concatenation order.
    """
    dir_norm = torch.linalg.norm(ray_directions, dim=-1)[..., None]
    t_cat = torch.cat(list(all_ray_positions_t), dim=-1)
    raw_alpha_cat = torch.cat(list(all_raw_alphas), dim=-1)
    total = t_cat.shape[-1]
    idx = torch.arange(total, device=t_cat.device)
    idx_after = idx[:, None] < idx[None, :]
    t_i = t_cat[..., :, None]
    t_j = t_cat[..., None, :]
    after = (t_j > t_i) | ((t_j == t_i) & idx_after)
    next_t = torch.where(after, t_j, torch.full_like(t_j, BIG)).amin(dim=-1)
    deltas = torch.where(next_t >= BIG, LAST_DISTANCE, next_t - t_cat)
    distances = deltas * dir_norm

    if noise is not None:
        raw_alpha_cat = raw_alpha_cat + noise
    x = torch.relu(raw_alpha_cat) * distances
    alphas = 1.0 - torch.exp(-x)
    log1m = torch.logaddexp(-x, torch.full_like(x, math.log(1e-10)))

    sizes = [t.shape[-1] for t in all_ray_positions_t]

    def exclusive_cumsum(v):
        cs = torch.cumsum(v, dim=-1)
        return torch.cat([torch.zeros_like(cs[..., :1]), cs[..., :-1]], dim=-1)

    own_exclusive = torch.cat([exclusive_cumsum(part) for part in torch.split(log1m, sizes, dim=-1)], dim=-1)
    object_of = torch.repeat_interleave(torch.arange(len(sizes), device=t_cat.device),
                                        torch.tensor(sizes, device=t_cat.device))
    same_object = object_of[:, None] == object_of[None, :]
    before = ((t_j < t_i) | ((t_j == t_i) & idx_after.t())) & ~same_object
    cross = torch.sum(torch.where(before, log1m[..., None, :], 0.0), dim=-1)
    weights = alphas * torch.exp(own_exclusive + cross)

    features_cat = torch.cat(list(all_raw_features), dim=-2)
    depth = torch.sum(weights * t_cat, dim=-1)
    opacity = torch.sum(weights, dim=-1)
    results = {
        "integrated_features": torch.sum(weights[..., None] * features_cat, dim=-2),
        "opacity": opacity,
        "weights": weights,
        "depth": depth,
        "disparity": _disparity(depth, opacity),
    }
    if all_ray_divergences is not None:
        div_cat = torch.cat(list(all_ray_divergences), dim=-1)
        results["integrated_divergence"] = torch.mean(alphas.detach() * torch.abs(div_cat), dim=-1)
    if all_ray_displacements is not None:
        disp_cat = torch.cat(list(all_ray_displacements), dim=-2)
        results["integrated_displacements_magnitude"] = torch.mean(
            weights.detach() * torch.linalg.norm(disp_cat, dim=-1), dim=-1
        )
    return results
