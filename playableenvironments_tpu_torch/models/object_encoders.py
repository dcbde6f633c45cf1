"""Object style/deformation encoders: CNNs over fixed-size object crops.

Port of playableenvironments_tpu/models/object_encoders.py:
ObjectEncoderV4 (dynamic objects: camera-conditioned, with a learned
attention mask) and ObjectEncoderV5 (backgrounds: deeper, no camera
conditioning), in train mode (batch statistics, running statistics
updated) and eval mode. Inputs and outputs are NHWC as in the JAX package;
the convolutions (library convs, as XLA's are in the JAX package) run in
NCHW. Every downsampling is an avg_pool or V5's explicitly padded stride-2
conv1, so no asymmetric SAME padding arises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.config import ObjectEncoderConfig
from playableenvironments_tpu_torch.models.layers import BatchNorm, ResidualBlock, avg_pool, conv
from playableenvironments_tpu_torch.ops.roi_crop import crop_and_resize, expand_boxes, roi_pool


def _crops(cfg: ObjectEncoderConfig, observations: torch.Tensor, bounding_boxes: torch.Tensor) -> torch.Tensor:
    """(N, in_h, in_w, 3) crops of the expanded boxes, under cfg.crop_mode."""
    height, width = observations.shape[1], observations.shape[2]
    boxes = expand_boxes(bounding_boxes, cfg.expansion_rows, cfg.expansion_cols)
    scale = torch.tensor([width, height, width, height], dtype=boxes.dtype, device=boxes.device)
    crop = roi_pool if cfg.crop_mode == "roi_pool" else crop_and_resize
    return crop(observations, boxes * scale, tuple(cfg.input_size))


class ObjectEncoderV4(nn.Module):
    """crop ++ broadcast camera pose -> conv, a residual block emitting an
    attention channel, four residual blocks -> style and deformation heads."""

    def __init__(self, cfg: ObjectEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = conv(3 + 6, 16, 3, device=device)
        self.bn1 = BatchNorm(16, device=device)
        self.initial = ResidualBlock(16, 16 + 1, 1, drop_final_activation=True, device=device)
        self.final_0 = ResidualBlock(16, 32, 2, device=device)
        self.final_1 = ResidualBlock(32, 32, 1, device=device)
        self.final_2 = ResidualBlock(32, 64, 2, device=device)
        self.final_3 = ResidualBlock(64, 64, 1, device=device)
        self.style_head = nn.Linear(64, cfg.style_features, device=device)
        self.deformation_head = nn.Linear(64, cfg.deformation_features, device=device)

    def forward(
        self,
        observations: torch.Tensor,
        bounding_boxes: torch.Tensor,
        camera_rotations: torch.Tensor,
        camera_translations: torch.Tensor,
        train: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """:param observations: (N, H, W, 3) first-camera frames.
        :param bounding_boxes: (N, 4) normalized (l, t, r, b).
        :param camera_rotations, camera_translations: (N, 3).
        :return: ((N, style), (N, deformation), (N, in_h/2, in_w/2, 1)
            attention, (N, in_h, in_w, 3) crops).
        """
        crops = _crops(self.cfg, observations, bounding_boxes)
        n, in_h, in_w, _ = crops.shape
        pose = torch.cat([camera_rotations, camera_translations], dim=-1)
        x = torch.cat([crops.permute(0, 3, 1, 2), pose[:, :, None, None].expand(n, 6, in_h, in_w)], dim=1)
        x = F.leaky_relu(self.bn1(avg_pool(self.conv1(x), 2), train), 0.2)
        initial = self.initial(x, train)
        attention = torch.sigmoid(initial[:, -1:])
        y = F.leaky_relu(initial[:, :-1], 0.2) * attention
        for block in (self.final_0, self.final_1, self.final_2, self.final_3):
            y = block(y, train)
        pooled = y.mean(dim=(2, 3))
        return (self.style_head(pooled), self.deformation_head(pooled),
                attention.permute(0, 2, 3, 1), crops)


class ObjectEncoderV5(nn.Module):
    """crop -> 7x7/2 conv, eight residual blocks to 512 features -> style and
    deformation heads; the attention is all ones."""

    _BLOCKS = (("initial_0", 64, 64, 2), ("initial_1", 64, 64, 1),
               ("final_0", 64, 128, 2), ("final_1", 128, 128, 1),
               ("final_2", 128, 256, 2), ("final_3", 256, 256, 1),
               ("final_4", 256, 512, 2), ("final_5", 512, 512, 1))

    def __init__(self, cfg: ObjectEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = conv(3, 64, 7, stride=2, padding=3, device=device)
        self.bn1 = BatchNorm(64, device=device)
        for name, cin, cout, df in self._BLOCKS:
            self.add_module(name, ResidualBlock(cin, cout, df, device=device))
        self.style_head = nn.Linear(512, cfg.style_features, device=device)
        self.deformation_head = nn.Linear(512, cfg.deformation_features, device=device)

    def forward(
        self,
        observations: torch.Tensor,
        bounding_boxes: torch.Tensor,
        camera_rotations: torch.Tensor = None,
        camera_translations: torch.Tensor = None,
        train: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Same surface as ObjectEncoderV4; the camera arguments are ignored."""
        crops = _crops(self.cfg, observations, bounding_boxes)
        n, in_h, in_w, _ = crops.shape
        x = F.leaky_relu(self.bn1(self.conv1(crops.permute(0, 3, 1, 2)), train), 0.2)
        for name, *_ in self._BLOCKS:
            x = getattr(self, name)(x, train)
        pooled = x.mean(dim=(2, 3))
        attention = torch.ones((n, in_h // 2, in_w // 2, 1), dtype=observations.dtype, device=observations.device)
        return self.style_head(pooled), self.deformation_head(pooled), attention, crops


def object_encoder(cfg: ObjectEncoderConfig, device=None) -> nn.Module:
    return (ObjectEncoderV4 if cfg.kind == "v4" else ObjectEncoderV5)(cfg, device=device)
