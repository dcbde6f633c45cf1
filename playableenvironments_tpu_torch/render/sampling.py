"""Whole-frame strided-grid ray sampling.

Port of the eval samplers of playableenvironments_tpu/render/sampling.py:
`sample_all_rays_strided_grid` and its inverse `split_strided_grid_samples`.
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
