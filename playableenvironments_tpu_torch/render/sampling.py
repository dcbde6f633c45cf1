"""Ray sampling over the pixel grid.

Port of playableenvironments_tpu/render/sampling.py: the whole-frame
strided grid (`sample_all_rays_strided_grid`, `split_strided_grid_samples`)
and the training samplers (`build_weight_image`,
`sample_indices_from_weights`, `gather_pixels`, `indices_to_positions`,
`sample_rays_uniform`, `sample_rays_weighted`). Where the JAX samplers draw
from a key, these take the draws: uniform values in [0, 1) for the
weighted sampler, integer indices for the uniform one. Pixel grids are
(..., H, W, F), samples (..., n, F), positions (..., n, 2) normalized
(row, col).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch


def sample_all_rays_strided_grid(
    ray_directions: torch.Tensor,
    observations: torch.Tensor,
    strides: Union[int, Sequence[int]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each stride s, the center pixel of every (s x s) cell, flattened
    row-major and concatenated over strides.

    :param ray_directions, observations: (..., H, W, 3).
    :return: ((..., n, 3) directions, (..., n, 3) observations,
              (..., n, 2) normalized (row, col) positions).
    """
    if isinstance(strides, int):
        strides = [strides]
    h, w = ray_directions.shape[-3], ray_directions.shape[-2]
    device = ray_directions.device

    all_dirs, all_obs, all_pos = [], [], []
    for stride in strides:
        if h % stride or w % stride:
            raise ValueError(f"image size ({h}, {w}) not divisible by stride {stride}")
        off = stride // 2
        dirs = ray_directions[..., off::stride, off::stride, :]
        obs = observations[..., off::stride, off::stride, :]
        gh, gw = h // stride, w // stride
        rows = (torch.arange(gh, device=device) * stride + off) / h
        cols = (torch.arange(gw, device=device) * stride + off) / w
        pos = torch.stack(torch.broadcast_tensors(rows[:, None], cols[None, :]), dim=-1)
        pos = pos.to(ray_directions.dtype).expand(dirs.shape[:-1] + (2,))
        all_dirs.append(dirs.reshape(dirs.shape[:-3] + (gh * gw, 3)))
        all_obs.append(obs.reshape(obs.shape[:-3] + (gh * gw, 3)))
        all_pos.append(pos.reshape(pos.shape[:-3] + (gh * gw, 2)))

    return (
        torch.cat(all_dirs, dim=-2),
        torch.cat(all_obs, dim=-2),
        torch.cat(all_pos, dim=-2),
    )


def split_strided_grid_samples(
    samples: torch.Tensor,
    strides: Sequence[int],
    image_size: Tuple[int, int],
    axis: int = -2,
) -> List[torch.Tensor]:
    """Fold the concatenated output of `sample_all_rays_strided_grid` back
    into rectangular (..., H/s, W/s, F) grids, one per stride."""
    h, w = image_size
    axis = axis % samples.dim()
    out, begin = [], 0
    for stride in strides:
        gh, gw = h // stride, w // stride
        chunk = samples.narrow(axis, begin, gh * gw)
        out.append(chunk.reshape(chunk.shape[:axis] + (gh, gw) + chunk.shape[axis + 1 :]))
        begin += gh * gw
    return out


def build_weight_image(bounding_boxes: torch.Tensor, weights: Sequence[float], height: int, width: int) -> torch.Tensor:
    """Per-pixel sampling weights: each object adds weight / area over its
    pixel-aligned box.

    :param bounding_boxes: (..., objects, 4) normalized (l, t, r, b).
    :return: (..., height, width).
    """
    w = torch.tensor(weights, dtype=bounding_boxes.dtype, device=bounding_boxes.device)
    left = torch.floor(bounding_boxes[..., 0] * width)
    right = torch.ceil(bounding_boxes[..., 2] * width)
    top = torch.floor(bounding_boxes[..., 1] * height)
    bottom = torch.ceil(bounding_boxes[..., 3] * height)
    area = torch.clamp((right - left) * (bottom - top), min=1.0)
    rows = torch.arange(height, dtype=bounding_boxes.dtype, device=bounding_boxes.device)[:, None]
    cols = torch.arange(width, dtype=bounding_boxes.dtype, device=bounding_boxes.device)[None, :]
    inside = (
        (rows >= top[..., None, None]) & (rows < bottom[..., None, None])
        & (cols >= left[..., None, None]) & (cols < right[..., None, None])
    )
    return torch.sum(inside * (w / area)[..., None, None], dim=-3)


def sample_indices_from_weights(weight_image: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF flat pixel indices; an all-zero weight image samples
    uniformly.

    :param weight_image: (..., H, W); :param uniform: (..., samples) in [0, 1).
    :return: (..., samples) int64 indices into H * W.
    """
    flat = weight_image.reshape(weight_image.shape[:-2] + (-1,))
    total = flat.sum(dim=-1, keepdim=True)
    flat = torch.where(total > 0, flat, torch.ones_like(flat))
    cdf = torch.cumsum(flat / flat.sum(dim=-1, keepdim=True), dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), uniform.contiguous(), side="left")
    return torch.clamp(idx, 0, flat.shape[-1] - 1)


def gather_pixels(grid: torch.Tensor, flat_indices: torch.Tensor) -> torch.Tensor:
    """(..., H, W, F) at (..., n) flat pixel indices -> (..., n, F)."""
    h, w, f = grid.shape[-3:]
    flat = grid.reshape(grid.shape[:-3] + (h * w, f))
    index = flat_indices[..., None].expand(flat_indices.shape + (f,))
    return torch.take_along_dim(flat.expand(index.shape[:-2] + flat.shape[-2:]), index, dim=-2)


def indices_to_positions(flat_indices: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Flat indices -> (..., 2) normalized (row, col)."""
    rows = torch.div(flat_indices, width, rounding_mode="floor").to(torch.float32) / height
    cols = (flat_indices % width).to(torch.float32) / width
    return torch.stack([rows, cols], dim=-1)


def _gather_samples(ray_directions, observations, idx):
    h, w = ray_directions.shape[-3], ray_directions.shape[-2]
    return gather_pixels(ray_directions, idx), gather_pixels(observations, idx), indices_to_positions(idx, h, w)


def sample_rays_uniform(
    ray_directions: torch.Tensor, observations: torch.Tensor, indices: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rays at uniformly drawn pixels.

    :param indices: (..., n) flat pixel indices drawn uniformly in [0, H W).
    :return: ((..., n, 3) directions, (..., n, 3) observations, (..., n, 2) positions).
    """
    return _gather_samples(ray_directions, observations, indices)


def sample_rays_weighted(
    ray_directions: torch.Tensor,
    observations: torch.Tensor,
    bounding_boxes: torch.Tensor,
    weights: Sequence[float],
    uniform: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Object-box-weighted rays: one inverse-CDF pick per uniform draw.

    :param bounding_boxes: (..., objects, 4) normalized (l, t, r, b).
    :param uniform: (..., n) draws in [0, 1).
    """
    h, w = ray_directions.shape[-3], ray_directions.shape[-2]
    idx = sample_indices_from_weights(build_weight_image(bounding_boxes, weights, h, w), uniform)
    return _gather_samples(ray_directions, observations, idx)
