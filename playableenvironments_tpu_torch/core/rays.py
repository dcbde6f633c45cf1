"""Camera rays and rigid ray transforms.

Port of playableenvironments_tpu/core/rays.py (camera_rays, transform_points,
transform_rays, stratified_ray_positions, and the hierarchical sampler's
sample_pdf and weighted_ray_positions). Everything broadcasts over leading
batch dimensions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def camera_rays(
    height: int, width: int, focal: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pinhole rays for each pixel, camera frame (looks along -z, y up).

    :param focal: (...) per-image focal lengths in pixels (float32).
    :return: ((..., height, width, 3) directions, (..., 3) origins,
              (..., 3) focal normals).
    """
    focal = torch.as_tensor(focal, dtype=torch.float32)
    f = focal[..., None, None]
    rows = torch.arange(height, dtype=torch.float32, device=focal.device)[:, None]
    cols = torch.arange(width, dtype=torch.float32, device=focal.device)[None, :]
    x = (cols - width / 2.0) / f
    y = -(rows - height / 2.0) / f  # image rows grow down; y grows up
    z = -torch.ones_like(x)  # cameras look along -z
    directions = torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)

    origins = torch.zeros(focal.shape + (3,), dtype=torch.float32, device=focal.device)
    normals = origins.clone()
    normals[..., 2] = -1.0
    return directions, origins, normals


def transform_points(
    points: torch.Tensor,
    matrix: torch.Tensor,
    rotate: bool = True,
    translate: bool = True,
) -> torch.Tensor:
    """Apply a (..., 4, 4) homogeneous transform to (..., 3) points."""
    out = points
    if rotate:
        out = torch.sum(out[..., None, :] * matrix[..., :3, :3], dim=-1)
    if translate:
        out = out + matrix[..., :3, 3]
    return out


def transform_rays(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    focal_normals: torch.Tensor,
    matrix: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Transform origins (rigid), directions and normals (rotation only).
    `ray_directions` (..., rays, 3) carries a rays axis the others lack."""
    origins = transform_points(ray_origins, matrix)
    normals = transform_points(focal_normals, matrix, translate=False)
    directions = transform_points(
        ray_directions, matrix[..., None, :, :], translate=False
    )
    return origins, directions, normals


def stratified_ray_positions(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    z_near: torch.Tensor,
    z_far: torch.Tensor,
    positions_count: int,
    uniform: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`positions_count` points per ray, linspace in [z_near, z_far]; with
    `uniform` (training's perturbation), each point jittered within its
    stratum to lower + (upper - lower) * uniform.

    :param ray_origins: (..., 3); ray_directions (..., rays, 3).
    :param z_near, z_far: (..., rays) per-ray bounds.
    :param uniform: (..., rays, positions_count) draws in [0, 1), or None.
    :return: ((..., rays, positions, 3) points, (..., rays, positions) t).
    """
    shape = ray_directions.shape[:-1]
    z_near = torch.as_tensor(z_near, dtype=ray_origins.dtype, device=ray_origins.device).expand(shape)
    z_far = torch.as_tensor(z_far, dtype=ray_origins.dtype, device=ray_origins.device).expand(shape)
    fractions = torch.linspace(0.0, 1.0, positions_count, dtype=ray_origins.dtype, device=ray_origins.device)
    t = z_near[..., None] * (1.0 - fractions) + z_far[..., None] * fractions
    if uniform is not None:
        mids = (t[..., 1:] + t[..., :-1]) / 2.0
        upper = torch.cat([mids, t[..., -1:]], dim=-1)
        lower = torch.cat([t[..., :1], mids], dim=-1)
        t = lower + (upper - lower) * uniform
    points = ray_origins[..., None, None, :] + ray_directions[..., None, :] * t[..., None]
    return points, t


def sample_pdf(
    bin_delimiters: torch.Tensor,
    weights: torch.Tensor,
    positions_count: int,
    uniform: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of t values from a piecewise-constant pdf.

    :param bin_delimiters: (..., bins + 1) bin edges.
    :param weights: (..., bins) unnormalized weights.
    :param uniform: (..., positions_count) draws in [0, 1) (training's
        perturbation), or None for the evenly spaced linspace(0, 1).
    :return: (..., positions_count) sampled t values.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (positions_count,)
    if uniform is None:
        uniform = torch.linspace(0.0, 1.0, positions_count, dtype=cdf.dtype, device=cdf.device).expand(shape)
    u = uniform.expand(shape).contiguous()
    # jnp.searchsorted(side="right"): the first index whose value exceeds u.
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    last_bin = bin_delimiters.shape[-1] - 1
    bins = bin_delimiters.expand(cdf.shape[:-1] + bin_delimiters.shape[-1:])
    bins_below = torch.gather(bins, -1, torch.clamp(below, 0, last_bin))
    bins_above = torch.gather(bins, -1, torch.clamp(above, 0, last_bin))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def weighted_ray_positions(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    positions_count: int,
    reference_t: torch.Tensor,
    weights: torch.Tensor,
    uniform: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical (fine) sampling: `positions_count` new t values drawn
    from the coarse weights between the reference midpoints (the first and
    last weights dropped), detached, merged with the reference t values and
    sorted.

    :param ray_origins: (..., 3); ray_directions (..., rays, 3).
    :param reference_t: (..., rays, ref_positions) coarse t values.
    :param weights: (..., rays, ref_positions) coarse compositing weights.
    :param uniform: (..., rays, positions_count) draws, or None (linspace).
    :return: ((..., rays, positions + ref_positions, 3) points, matching t).
    """
    mids = (reference_t[..., 1:] + reference_t[..., :-1]) / 2.0
    new_t = sample_pdf(mids, weights[..., 1:-1], positions_count, uniform).detach()
    merged_t, _ = torch.sort(torch.cat([reference_t, new_t], dim=-1), dim=-1)
    points = ray_origins[..., None, None, :] + ray_directions[..., None, :] * merged_t[..., None]
    return points, merged_t


def pixel_grid_positions(height: int, width: int, device=None) -> torch.Tensor:
    """(height, width, 2) positions (row, col) normalized to [0, 1)."""
    rows = torch.arange(height, dtype=torch.float32, device=device)[:, None] / height
    cols = torch.arange(width, dtype=torch.float32, device=device)[None, :] / width
    return torch.stack(torch.broadcast_tensors(rows, cols), dim=-1)
