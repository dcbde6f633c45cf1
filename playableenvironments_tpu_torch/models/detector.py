"""Single-class player detector: a CenterNet heatmap with box size and
center offset regression.

Port of playableenvironments_tpu/models/detector.py: `CenterNetDetector`
(a 7x7/2 stem and a 3x3/2 downsampling, each with batch norm and ReLU, two
residual blocks, a 3x3 context convolution at dilation 2, and 1x1 heads for
the heatmap logits, whose bias starts at -2.19, and the sigmoid sizes and
offsets), `splat_gaussian_targets`, `detection_loss` (the penalty-reduced
focal loss and masked L1s) and `decode_detections` (a 3x3 max-pool NMS and
the top-k peaks). No pretrained detector ships with the repo: the detector
is trained on the dataset's own boxes (train/trainer_detector.py).

Tensors are NHWC at the interface, as in the JAX package; the convolutions
run NCHW inside. Their SAME padding is written out (ops/padding.py::
pad_same): at stride 2 on an even side flax pads the stem 2 before and 3
after, and `down1` 0 before and 1 after, which a symmetric torch padding
would shift by a pixel. Modules are named after the flax tree (`stem`,
`stem_bn`, `res1.conv1`, `heatmap_head`, ...), so compat/from_flax.py::
load_detector loads JAX variables by name.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.models.layers import BatchNorm, ResidualBlock, initialize_
from playableenvironments_tpu_torch.ops.padding import pad_same
from playableenvironments_tpu_torch.utils.device import resolve_device

HEATMAP_PRIOR = -2.19  # the focal loss's prior: sigmoid(-2.19) ~ 0.1


class CenterNetDetector(nn.Module):
    """Conv backbone of stride 4 -> center heatmap, box size, center offset,
    on seeded random weights (`seed`)."""

    def __init__(self, base_features: int = 32, device="cuda", seed: int = 0):
        super().__init__()
        f = base_features
        device = resolve_device(device)
        self.stem = nn.Conv2d(3, f, 7, stride=2, device=device)
        self.stem_bn = BatchNorm(f, device=device)
        self.down1 = nn.Conv2d(f, 2 * f, 3, stride=2, device=device)
        self.down1_bn = BatchNorm(2 * f, device=device)
        self.res1 = ResidualBlock(2 * f, 2 * f, device=device)
        self.res2 = ResidualBlock(2 * f, 2 * f, device=device)
        # Dilated context instead of further downsampling (keeps the H/4 output).
        self.context = nn.Conv2d(2 * f, 2 * f, 3, dilation=2, device=device)
        self.heatmap_head = nn.Conv2d(2 * f, 1, 1, device=device)
        self.size_head = nn.Conv2d(2 * f, 2, 1, device=device)
        self.offset_head = nn.Conv2d(2 * f, 2, 1, device=device)
        initialize_(self, torch.Generator().manual_seed(seed))

    def reset_special_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.heatmap_head.bias.fill_(HEATMAP_PRIOR)

    @staticmethod
    def _conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x, layer.kernel_size, layer.stride, layer.dilation)
        return F.conv2d(x, layer.weight, layer.bias, layer.stride, 0, layer.dilation)

    def forward(self, images: torch.Tensor, train: bool = True) -> Dict[str, torch.Tensor]:
        """:param images: (B, H, W, 3) in [0, 1].
        :param train: batch statistics (updating the running ones) or the
            running statistics.
        :return: heatmap (B, H/4, W/4) logits, sizes and offsets
            (B, H/4, W/4, 2) in (0, 1), sizes as fractions of the image."""
        y = images.permute(0, 3, 1, 2)
        y = torch.relu(self.stem_bn(self._conv(self.stem, y), train))
        y = torch.relu(self.down1_bn(self._conv(self.down1, y), train))
        y = self.res2(self.res1(y, train), train)
        y = torch.relu(self._conv(self.context, y))
        return {
            "heatmap": self.heatmap_head(y)[:, 0],
            "sizes": torch.sigmoid(self.size_head(y)).permute(0, 2, 3, 1),
            "offsets": torch.sigmoid(self.offset_head(y)).permute(0, 2, 3, 1),
        }


def splat_gaussian_targets(boxes: torch.Tensor, validity: torch.Tensor, grid_hw: Tuple[int, int],
                           min_sigma: float = 0.8) -> Dict[str, torch.Tensor]:
    """Dense training targets from normalized ltrb boxes.

    :param boxes: (B, O, 4) normalized (left, top, right, bottom) in [0, 1].
    :param validity: (B, O) bool.
    :param grid_hw: the heatmap's resolution (H/4, W/4).
    :return: heatmap (B, gh, gw) in [0, 1], sizes and offsets (B, gh, gw, 2),
        weight (B, gh, gw) marking the cells that own a center."""
    gh, gw = grid_hw
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5 * gh
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5 * gw
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], 0.0, 1.0)
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], 0.0, 1.0)
    rows = torch.arange(gh, device=boxes.device)[:, None]
    cols = torch.arange(gw, device=boxes.device)[None, :]
    valid = validity.to(boxes.dtype)[..., None, None]

    # One Gaussian an object, combined by max, centered on the integer
    # center cell so that the peak there is exactly 1 (detection_loss's
    # positives are gt > 0.999).
    center_r = torch.clamp(torch.floor(cy), 0, gh - 1)
    center_c = torch.clamp(torch.floor(cx), 0, gw - 1)
    sigma_r = torch.clamp(h * gh / 6.0, min=min_sigma)[..., None, None]
    sigma_c = torch.clamp(w * gw / 6.0, min=min_sigma)[..., None, None]
    d_r = rows - center_r[..., None, None]
    d_c = cols - center_c[..., None, None]
    per_object = torch.exp(-(d_r ** 2) / (2 * sigma_r ** 2) - (d_c ** 2) / (2 * sigma_c ** 2)) * valid
    heatmap = per_object.max(dim=-3).values

    # The center cell's regression targets. The index truncates toward
    # zero, as the JAX package's astype(int32) does.
    r_idx = torch.clamp(cy.to(torch.int32), 0, gh - 1)
    c_idx = torch.clamp(cx.to(torch.int32), 0, gw - 1)
    is_center = (rows == r_idx[..., None, None]) & (cols == c_idx[..., None, None]) & validity[..., None, None]

    def scatter(values):  # (B, O) -> (B, gh, gw), a masked max over objects
        return torch.where(is_center, values[..., None, None], torch.zeros((), dtype=values.dtype,
                                                                           device=values.device)).max(dim=-3).values

    sizes = torch.stack([scatter(h), scatter(w)], dim=-1)
    offsets = torch.stack([scatter(cy - torch.floor(cy)), scatter(cx - torch.floor(cx))], dim=-1)
    weight = is_center.any(dim=-3).to(boxes.dtype)
    return {"heatmap": heatmap, "sizes": sizes, "offsets": offsets, "weight": weight}


def detection_loss(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The CenterNet objective (arXiv:1904.07850): the penalty-reduced focal
    loss on the heatmap, masked L1s on sizes and offsets."""
    pred = torch.clamp(torch.sigmoid(outputs["heatmap"]), 1e-6, 1.0 - 1e-6)
    gt = targets["heatmap"]
    pos = (gt > 0.999).to(pred.dtype)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    pos_loss = -torch.log(pred) * (1.0 - pred) ** 2 * pos
    neg_loss = -torch.log(1.0 - pred) * pred ** 2 * (1.0 - gt) ** 4 * (1.0 - pos)
    heatmap_loss = (pos_loss.sum() + neg_loss.sum()) / n_pos

    w = targets["weight"][..., None]
    n_centers = torch.clamp(w.sum(), min=1.0)
    size_loss = (torch.abs(outputs["sizes"] - targets["sizes"]) * w).sum() / n_centers
    offset_loss = (torch.abs(outputs["offsets"] - targets["offsets"]) * w).sum() / n_centers
    return {"loss": heatmap_loss + size_loss + 0.5 * offset_loss, "heatmap_loss": heatmap_loss,
            "size_loss": size_loss, "offset_loss": offset_loss}


def decode_detections(outputs: Dict[str, torch.Tensor], top_k: int = 8) -> Dict[str, torch.Tensor]:
    """Fixed-size decode: a 3x3 max-pool NMS, then the top-k peaks.

    After the NMS most cells are exactly 0. `lax.top_k` returns tied entries
    lowest index first and `torch.topk` leaves their order unspecified, so
    the peaks come from a stable descending sort: every entry, not only
    those above a threshold, is the JAX package's.

    :return: scores (B, k), centers (B, k, 2) normalized (row, col), boxes
        (B, k, 4) normalized ltrb."""
    heat = torch.sigmoid(outputs["heatmap"])
    pooled = F.max_pool2d(heat[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(heat == pooled, heat, torch.zeros((), dtype=heat.dtype, device=heat.device))
    b, gh, gw = peaks.shape
    scores, idx = torch.sort(peaks.reshape(b, gh * gw), dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]
    r, c = idx // gw, idx % gw

    def gather(maps):  # (B, gh, gw, 2) -> (B, k, 2)
        return torch.gather(maps.reshape(b, gh * gw, 2), 1, idx[..., None].expand(-1, -1, 2))

    offsets, sizes = gather(outputs["offsets"]), gather(outputs["sizes"])
    cy = (r.to(heat.dtype) + offsets[..., 0]) / gh
    cx = (c.to(heat.dtype) + offsets[..., 1]) / gw
    h, w = sizes[..., 0], sizes[..., 1]
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    return {"scores": scores, "centers": torch.stack([cy, cx], dim=-1), "boxes": boxes}
