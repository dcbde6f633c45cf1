"""Fixed-size box crops of NHWC images.

Port of playableenvironments_tpu/ops/roi_crop.py: `crop_and_resize` (each
crop as two dense bilinear interpolation products, rows then columns),
`roi_pool` (torchvision's roi_pool semantics as masked row and column
maxima) and `expand_boxes`. Written as the same separable math, since the
port has no torchvision.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _interp_weights(positions: torch.Tensor, in_size: int) -> torch.Tensor:
    """(..., out) fractional source coordinates, clamped to [0, in_size - 1]
    -> (..., out, in_size) tent weights (rows sum to 1)."""
    p = torch.clamp(positions, 0.0, in_size - 1.0)[..., None]
    s = torch.arange(in_size, dtype=positions.dtype, device=positions.device)
    return torch.clamp(1.0 - torch.abs(p - s), min=0.0)


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear crops sampled at bin centers across each box.

    :param images: (N, H, W, C); :param boxes: (N, 4) pixel (l, t, r, b).
    :return: (N, out_h, out_w, C).
    """
    out_h, out_w = out_size
    h, w = images.shape[1], images.shape[2]
    left, top, right, bottom = boxes.unbind(-1)
    iy = (torch.arange(out_h, dtype=boxes.dtype, device=boxes.device) + 0.5) / out_h
    ix = (torch.arange(out_w, dtype=boxes.dtype, device=boxes.device) + 0.5) / out_w
    ys = top[:, None] + iy * (bottom - top)[:, None] - 0.5
    xs = left[:, None] + ix * (right - left)[:, None] - 0.5
    wy = _interp_weights(ys, h)
    wx = _interp_weights(xs, w)
    rows = torch.einsum("nhH,nHWc->nhWc", wy, images)
    return torch.einsum("nwW,nhWc->nhwc", wx, rows)


def roi_pool(images: torch.Tensor, boxes: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """torchvision.ops.roi_pool (spatial_scale 1): quantized bins, the max
    over each bin's pixels, 0 for an empty bin.

    :param images: (N, H, W, C); :param boxes: (N, 4) pixel (l, t, r, b).
    :return: (N, out_h, out_w, C).
    """
    out_h, out_w = out_size
    h, w = images.shape[1], images.shape[2]
    start_w, start_h, end_w, end_h = torch.floor(boxes + 0.5).unbind(-1)
    roi_w = torch.clamp(end_w - start_w + 1.0, min=1.0)
    roi_h = torch.clamp(end_h - start_h + 1.0, min=1.0)
    bin_h, bin_w = roi_h / out_h, roi_w / out_w
    ph = torch.arange(out_h, dtype=boxes.dtype, device=boxes.device)
    pw = torch.arange(out_w, dtype=boxes.dtype, device=boxes.device)
    hstart = torch.clamp(torch.floor(ph[None] * bin_h[:, None]) + start_h[:, None], 0, h)
    hend = torch.clamp(torch.ceil((ph[None] + 1.0) * bin_h[:, None]) + start_h[:, None], 0, h)
    wstart = torch.clamp(torch.floor(pw[None] * bin_w[:, None]) + start_w[:, None], 0, w)
    wend = torch.clamp(torch.ceil((pw[None] + 1.0) * bin_w[:, None]) + start_w[:, None], 0, w)
    ys = torch.arange(h, dtype=boxes.dtype, device=boxes.device)
    xs = torch.arange(w, dtype=boxes.dtype, device=boxes.device)
    mask_h = (ys >= hstart[..., None]) & (ys < hend[..., None])  # (N, out_h, H)
    mask_w = (xs >= wstart[..., None]) & (xs < wend[..., None])  # (N, out_w, W)
    neg_inf = torch.tensor(float("-inf"), dtype=images.dtype, device=images.device)
    rows = torch.where(mask_h[..., None, None], images[:, None], neg_inf).amax(dim=2)  # (N, out_h, W, C)
    out = torch.where(mask_w[:, None, :, :, None], rows[:, :, None], neg_inf).amax(dim=3)
    empty = (hend <= hstart)[:, :, None] | (wend <= wstart)[:, None, :]
    return torch.where(empty[..., None], torch.zeros((), dtype=images.dtype, device=images.device), out)


def expand_boxes(boxes: torch.Tensor, expansion_rows: float, expansion_cols: float) -> torch.Tensor:
    """Expand normalized (l, t, r, b) boxes sideways and upward (never down),
    clamped to [0, 1]."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    expanded = torch.stack(
        [boxes[..., 0] - w * expansion_cols, boxes[..., 1] - h * expansion_rows,
         boxes[..., 2] + w * expansion_cols, boxes[..., 3]],
        dim=-1,
    )
    return torch.clamp(expanded, 0.0, 1.0)
