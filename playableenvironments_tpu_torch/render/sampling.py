"""Ray sampling over the pixel grid.

Port of playableenvironments_tpu/render/sampling.py: the whole-frame
strided grid (`sample_all_rays_strided_grid`, `split_strided_grid_samples`)
and the training samplers (`build_weight_image`,
`sample_indices_from_weights`, `gather_pixels`, `indices_to_positions`,
`sample_rays_uniform`, `sample_rays_weighted`) and the decoder path's
strided patches (`sample_rays_strided_patch`, `split_strided_samples`,
`samples_to_patch`, `crop_region_from_patch_positions`), and the
consistency passes' samplers (`sample_at_positions`, the bilinear grid
sample; `sample_rays_at_object`; `sample_rays_at_keypoints` along
`COCO_SEGMENTS`). Where the JAX samplers draw from a key, these take the
draws: uniform values in [0, 1) for the weighted, patch, object-box and
keypoint samplers, integer indices for the uniform one. Pixel grids are
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


def _align_start(start: torch.Tensor, stride: int) -> torch.Tensor:
    """Move `start` to the nearest value congruent to stride // 2 (mod
    stride), going down when possible. `start` may be negative: the
    remainders are floor-mod (torch.remainder), as jnp.mod's."""
    half = stride // 2
    delta_down = torch.remainder(start - half, stride)
    delta_up = torch.remainder(half - start, stride)
    return torch.where(start >= half, start - delta_down, start + delta_up)


def strided_patch_sizes(patch_size: int, strides: Sequence[int]) -> List[int]:
    """Per-stride patch sides: the patch covers the same image region at
    every stride, so sizes scale inversely to the stride."""
    smallest = strides[0]
    sizes = []
    for s in strides:
        if (patch_size * smallest) % s != 0:
            raise ValueError(f"patch_size {patch_size} incompatible with stride {s}")
        sizes.append((patch_size * smallest) // s)
    return sizes


def sample_rays_strided_patch(
    ray_directions: torch.Tensor,
    observations: torch.Tensor,
    patch_size: int,
    strides: Union[int, Sequence[int]],
    bounding_boxes: torch.Tensor,
    weights: Sequence[float],
    uniform: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One grid-aligned multi-resolution patch per image: the centre is
    drawn from the object-weighted distribution and clipped so that the
    coarsest patch stays inside the image; for each stride s a
    (p_s x p_s) grid of rays at the centres of (s x s) cells, strides
    concatenated along the sample axis, smallest first.

    :param uniform: (..., 1) draws in [0, 1) for the patch centre.
    :return: ((..., sum p_s^2, 3) directions, observations, (..., sum, 2)
        positions).
    """
    if isinstance(strides, int):
        strides = [strides]
    if patch_size % 2 != 0:
        raise ValueError("patch_size must be even")
    patch_sizes = strided_patch_sizes(patch_size, strides)
    biggest_stride, biggest_patch = strides[-1], patch_sizes[-1]
    h, w = ray_directions.shape[-3], ray_directions.shape[-2]
    weight_image = build_weight_image(bounding_boxes, weights, h, w)
    center_idx = sample_indices_from_weights(weight_image, uniform)[..., 0]
    center_row = torch.div(center_idx, w, rounding_mode="floor")
    center_col = center_idx % w
    half = biggest_patch // 2
    center_row = torch.clamp(center_row, half * biggest_stride, h - biggest_stride * (half - 1) - 1)
    center_col = torch.clamp(center_col, half * biggest_stride, w - biggest_stride * (half - 1) - 1)
    start_row = _align_start(center_row - half * biggest_stride, biggest_stride)
    start_col = _align_start(center_col - half * biggest_stride, biggest_stride)

    all_indices = []
    for stride, p in zip(strides, patch_sizes):
        offset = biggest_stride // 2 - stride // 2
        steps = torch.arange(p, device=center_idx.device) * stride
        rows = (start_row - offset)[..., None, None] + steps[:, None]
        cols = (start_col - offset)[..., None, None] + steps[None, :]
        all_indices.append((rows * w + cols).reshape(start_row.shape + (p * p,)))
    return _gather_samples(ray_directions, observations, torch.cat(all_indices, dim=-1))


def split_strided_samples(samples: torch.Tensor, patch_size: int, strides: Sequence[int]) -> List[torch.Tensor]:
    """Split concatenated strided-patch samples (..., n, F) into per-stride
    chunks."""
    out, begin = [], 0
    for p in strided_patch_sizes(patch_size, strides):
        out.append(samples[..., begin : begin + p * p, :])
        begin += p * p
    return out


def samples_to_patch(samples: torch.Tensor) -> torch.Tensor:
    """(..., p^2, F) -> (..., p, p, F), row-major."""
    p2, f = samples.shape[-2], samples.shape[-1]
    p = int(round(p2 ** 0.5))
    if p * p != p2:
        raise ValueError(f"sample count {p2} is not a square")
    return samples.reshape(samples.shape[:-2] + (p, p, f))


def crop_region_from_patch_positions(
    images: torch.Tensor, patch_positions: torch.Tensor, patch_size: int, stride: int
) -> torch.Tensor:
    """The pixel region a strided patch covers: it starts stride // 2
    pixels before the first finest-stride sample and spans patch_size *
    stride pixels. The start is recovered as JAX does: f32 position times
    the image side, truncated.

    :param images: (..., H, W, C); patch_positions (..., n, 2) normalized
        (row, col) of the finest stride's samples.
    :return: (..., patch_size * stride, patch_size * stride, C).
    """
    h, w = images.shape[-3], images.shape[-2]
    first = patch_positions[..., 0, :]
    size = patch_size * stride
    start_row = torch.clamp((first[..., 0] * h).to(torch.int32) - stride // 2, 0, h - size)
    start_col = torch.clamp((first[..., 1] * w).to(torch.int32) - stride // 2, 0, w - size)
    steps = torch.arange(size, device=images.device)
    rows = (start_row.long()[..., None] + steps)[..., :, None]
    cols = (start_col.long()[..., None] + steps)[..., None, :]
    flat = (rows * w + cols).reshape(start_row.shape + (size * size,))
    crops = gather_pixels(images, flat)
    return crops.reshape(crops.shape[:-2] + (size, size, images.shape[-1]))


# COCO skeleton edges along which the keypoint samples are drawn.
COCO_SEGMENTS = (
    (0, 11), (0, 12), (5, 6), (5, 7), (5, 11), (5, 12), (6, 8), (6, 11),
    (6, 12), (7, 9), (8, 10), (11, 12), (11, 13), (12, 14), (13, 15),
    (14, 16),
)


def sample_at_positions(grid: torch.Tensor, positions: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """Bilinear samples of a pixel grid at continuous normalized positions,
    clamped to the grid's edge pixels.

    :param grid: (..., H, W, F); positions (..., n, 2) normalized (row, col).
    :param align_corners: True maps 0 to the first and 1 to the last pixel
        centre (the convention of the ray-direction grids); False maps
        pixel i to (i + 0.5) / side.
    :return: (..., n, F).
    """
    h, w = grid.shape[-3], grid.shape[-2]
    if align_corners:
        r = positions[..., 0] * (h - 1)
        c = positions[..., 1] * (w - 1)
    else:
        r = positions[..., 0] * h - 0.5
        c = positions[..., 1] * w - 0.5
    r = torch.clamp(r, 0.0, h - 1)
    c = torch.clamp(c, 0.0, w - 1)
    r0 = torch.clamp(torch.floor(r).to(torch.int64), 0, h - 1)
    c0 = torch.clamp(torch.floor(c).to(torch.int64), 0, w - 1)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    c1 = torch.clamp(c0 + 1, max=w - 1)
    wr = (r - r0)[..., None]
    wc = (c - c0)[..., None]
    top = gather_pixels(grid, r0 * w + c0) * (1 - wc) + gather_pixels(grid, r0 * w + c1) * wc
    bottom = gather_pixels(grid, r1 * w + c0) * (1 - wc) + gather_pixels(grid, r1 * w + c1) * wc
    return top * (1 - wr) + bottom * wr


def sample_rays_at_object(
    ray_directions: torch.Tensor, feature_images: torch.Tensor, bounding_box: torch.Tensor, uniform: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rays drawn uniformly inside an object's 2D box (a zero-area box draws
    over the whole image), with the feature image's values at the drawn
    pixels.

    :param ray_directions: (..., H, W, 3); feature_images (..., H, W, F)
        (e.g. optical flow); bounding_box (..., 4) normalized ltrb.
    :param uniform: (..., n) draws in [0, 1).
    :return: (directions (..., n, 3), features (..., n, F), positions
        (..., n, 2) normalized (row, col)).
    """
    h, w = ray_directions.shape[-3], ray_directions.shape[-2]
    idx = sample_indices_from_weights(build_weight_image(bounding_box[..., None, :], [1.0], h, w), uniform)
    return gather_pixels(ray_directions, idx), gather_pixels(feature_images, idx), indices_to_positions(idx, h, w)


def sample_rays_at_keypoints(
    ray_directions: torch.Tensor, keypoints: torch.Tensor, uniform: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rays at random points of the COCO skeleton drawn by the 2D keypoints:
    sample i sits on segment i mod 16 at the fraction uniform[..., i, 0],
    one fraction per sequence and sample, shared over the observation and
    camera axes, so that a sample is the same body point in every frame.

    :param ray_directions: (..., T, C, H, W, 3).
    :param keypoints: (..., T, C, K, 3) normalized (row, col, confidence).
    :param uniform: (..., 1, 1, n, 1) draws in [0, 1), n the samples an image.
    :return: (directions (..., T, C, n, 3), positions (..., T, C, n, 2),
        confidences (..., T, C, n)).
    """
    n = uniform.shape[-2]
    segments = torch.tensor(COCO_SEGMENTS, device=keypoints.device)
    reps = -(-n // len(COCO_SEGMENTS))
    begins = keypoints[..., segments[:, 0], :].repeat((1,) * (keypoints.dim() - 2) + (reps, 1))[..., :n, :]
    ends = keypoints[..., segments[:, 1], :].repeat((1,) * (keypoints.dim() - 2) + (reps, 1))[..., :n, :]
    points = begins + (ends - begins) * uniform
    positions = points[..., :2]
    return sample_at_positions(ray_directions, positions), positions, points[..., 2]
