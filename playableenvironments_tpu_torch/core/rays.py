"""Camera rays and rigid ray transforms.

Port of playableenvironments_tpu/core/rays.py (camera_rays, transform_points,
transform_rays, stratified_ray_positions). Everything broadcasts over
leading batch dimensions.
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
