"""The feature renderer's multiresolution decoder, eval mode.

Port of the decode half of playableenvironments_tpu/models/autoencoder.py:
CycleGAN residual blocks (reflect padding, BN), bilinear x2 upsampling convs
and unactivated skip concatenation, ending in a 7x7 conv + sigmoid. Public
tensors are NHWC as in the JAX package; the convolutions run NCHW inside.
The convolutions are library convolutions, as the JAX package leaves them to
XLA; f32 convolutions follow torch.backends.cudnn.allow_tf32, which this
module never sets. The encoder comes with the phase-1 slice.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.config import AutoencoderConfig
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.ops.padding import reflect_pad_hw
from playableenvironments_tpu_torch.utils.device import resolve_device


def features_count_by_layer(cfg: AutoencoderConfig) -> List[int]:
    """Per-level bottleneck widths; their sum is what the NeRF must emit."""
    initial = cfg.bottleneck_features // (2 ** sum(cfg.downsampling_layers_count))
    counts, cumulative = [], 0
    for d in cfg.downsampling_layers_count:
        cumulative += d
        counts.append(initial * (2 ** cumulative))
    return counts


def autoencoder_strides(cfg: AutoencoderConfig) -> List[int]:
    """Pixel stride of each latent level, e.g. (2, 1) -> (4, 8)."""
    strides, cumulative = [], 0
    for d in cfg.downsampling_layers_count:
        cumulative += d
        strides.append(2 ** cumulative)
    return strides


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsampling of NCHW, half-pixel centers, edges clamped:
    what jax.image.resize(..., "bilinear") gives for a factor of 2."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class CycleGanResnetBlock(nn.Module):
    """[reflect-pad conv3x3 BN ReLU] x2 (second without ReLU), with a 1x1
    conv + BN projection on the skip when widths differ."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, out_features, 3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(out_features, device=device)
        self.conv2 = nn.Conv2d(out_features, out_features, 3, bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(out_features, device=device)
        if in_features != out_features:
            self.skip_conv = nn.Conv2d(in_features, out_features, 1, bias=False, device=device)
            self.skip_bn = nn.BatchNorm2d(out_features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(reflect_pad_hw(x, 1))))
        y = self.bn2(self.conv2(reflect_pad_hw(y, 1)))
        residual = x
        if hasattr(self, "skip_conv"):
            residual = self.skip_bn(self.skip_conv(x))
        return residual + y


class MultiresDecoder(nn.Module):
    """Reference DecoderV6 (the v8 autoencoder) and DecoderV7 (v9) in eval
    mode: from the lowest-resolution latent upward, bottleneck blocks,
    bilinear-upsample convs and skip concatenation of the next level's
    latent, then a 7x7 conv + sigmoid. v9 adds a ReLU after each bottleneck
    block and, in sets of 3 or more upsamplings, `mid_res` blocks (each
    followed by a ReLU) after the second-to-last upsampling."""

    def __init__(self, cfg: AutoencoderConfig, device=None):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"decoder compute_dtype {cfg.compute_dtype!r}: the port's decoder "
                "runs float32 only so far"
            )
        self.cfg = cfg
        counts = cfg.downsampling_layers_count
        initial = cfg.bottleneck_features // (2 ** sum(counts))
        levels = features_count_by_layer(cfg)
        mult = 2 ** sum(counts)
        channels = levels[-1]
        reversed_counts = list(reversed(counts))
        for set_idx, downs in enumerate(reversed_counts):
            for b in range(cfg.bottleneck_blocks):
                self.add_module(
                    f"bottleneck_{set_idx}_{b}",
                    CycleGanResnetBlock(channels, initial * mult, device),
                )
                channels = initial * mult
            for i in range(downs):
                self.add_module(
                    f"up_{set_idx}_{i}",
                    nn.Conv2d(channels, initial * mult // 2, 3, bias=False, device=device),
                )
                self.add_module(f"up_bn_{set_idx}_{i}", nn.BatchNorm2d(initial * mult // 2, device=device))
                mult //= 2
                channels = initial * mult
                if self._mid_res(downs, i):
                    for b in range(cfg.bottleneck_blocks):
                        self.add_module(f"mid_res_{set_idx}_{b}", CycleGanResnetBlock(channels, channels, device))
            if set_idx != len(reversed_counts) - 1:
                channels += levels[-set_idx - 2]
        self.final_conv = nn.Conv2d(channels, cfg.input_features, 7, device=device)

    def _mid_res(self, downs: int, i: int) -> bool:
        return self.cfg.variant == "v9" and downs >= 3 and i == downs - 2

    def forward(self, encoded_levels: List[torch.Tensor]) -> torch.Tensor:
        """:param encoded_levels: per-level NCHW latents, level 0 at the
        highest resolution. :return: (N, input_features, H, W) in [0, 1]."""
        cfg = self.cfg
        deep = cfg.variant == "v9"
        y = encoded_levels[-1]
        reversed_counts = list(reversed(cfg.downsampling_layers_count))
        for set_idx, downs in enumerate(reversed_counts):
            for b in range(cfg.bottleneck_blocks):
                y = getattr(self, f"bottleneck_{set_idx}_{b}")(y)
                if deep:
                    y = torch.relu(y)
            for i in range(downs):
                y = reflect_pad_hw(upsample2x_bilinear(y), 1)
                y = getattr(self, f"up_{set_idx}_{i}")(y)
                y = torch.relu(getattr(self, f"up_bn_{set_idx}_{i}")(y))
                if self._mid_res(downs, i):
                    for b in range(cfg.bottleneck_blocks):
                        y = torch.relu(getattr(self, f"mid_res_{set_idx}_{b}")(y))
            if set_idx != len(reversed_counts) - 1:
                skip = encoded_levels[-set_idx - 2]
                y = torch.cat([y, skip], dim=1)
        return torch.sigmoid(self.final_conv(reflect_pad_hw(y, 3)))


class MultiresAutoencoder(nn.Module):
    """The VAE's decode surface (`decoder` weights); eval mode only."""

    def __init__(self, cfg: AutoencoderConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.decoder = MultiresDecoder(cfg, device=resolve_device(device))
        initialize_(self, torch.Generator().manual_seed(seed))
        self.eval()

    def decode(self, encoded_levels: List[torch.Tensor]) -> torch.Tensor:
        """:param encoded_levels: per-level (N, H/s, W/s, F) NHWC latents.
        :return: (N, H, W, input_features) reconstruction in [0, 1]."""
        with torch.no_grad():
            nchw = [level.permute(0, 3, 1, 2) for level in encoded_levels]
            return self.decoder(nchw).permute(0, 2, 3, 1)
