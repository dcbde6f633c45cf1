"""The feature renderer: the multiresolution variational autoencoder.

Port of playableenvironments_tpu/models/autoencoder.py: CycleGAN residual
blocks (reflect padding, BN), per-level strided downsampling with 2x2
average pools and a doubled last bottleneck (mean ++ log variance) in the
encoder; bilinear x2 upsampling convs and unactivated skip concatenation,
ending in a 7x7 conv + sigmoid, in the decoder. Public tensors are NHWC as
in the JAX package; the convolutions run NCHW inside. They are library
convolutions, as the JAX package leaves them to XLA (its space-to-depth
lowering is a TPU matter); f32 convolutions follow
torch.backends.cudnn.allow_tf32, which this module never sets.

`compute_dtype` bfloat16 runs the convolutions in bf16 (parameters stay
f32) and carries bf16 activations between them; batch norm is
models/layers.py's flax one, which takes its statistics in f32 and rounds
only its normalized output, as flax's `BatchNorm(dtype=...)` does.
With `remat`, each convolution stage and each residual block is a
rematerialized region (utils/remat.py): its convolution outputs are kept,
its batch norms, activations, pads and pools recomputed in the backward.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.config import AutoencoderConfig
from playableenvironments_tpu_torch.models.layers import BatchNorm, initialize_
from playableenvironments_tpu_torch.ops.padding import reflect_pad_hw
from playableenvironments_tpu_torch.utils import remat as remat_lib
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


def _region(remat: bool, fn, *args):
    return remat_lib.checkpointed(fn, *args) if remat else fn(*args)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer` with its input, kernel and bias cast to `dtype` (flax Conv
    with `dtype`)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias)


class CycleGanResnetBlock(nn.Module):
    """[reflect-pad conv3x3 BN ReLU] x2 (second without ReLU), with a 1x1
    conv + BN projection on the skip when widths differ."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, out_features, 3, bias=False, device=device)
        self.bn1 = BatchNorm(out_features, device=device)
        self.conv2 = nn.Conv2d(out_features, out_features, 3, bias=False, device=device)
        self.bn2 = BatchNorm(out_features, device=device)
        if in_features != out_features:
            self.skip_conv = nn.Conv2d(in_features, out_features, 1, bias=False, device=device)
            self.skip_bn = BatchNorm(out_features, device=device)

    def forward(self, x: torch.Tensor, train: bool = False, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        y = conv(self.conv1, reflect_pad_hw(x.to(dtype), 1), dtype)
        y = torch.relu(self.bn1(y, train, dtype))
        y = self.bn2(conv(self.conv2, reflect_pad_hw(y, 1), dtype), train, dtype)
        residual = x.to(y.dtype)
        if hasattr(self, "skip_conv"):
            residual = self.skip_bn(conv(self.skip_conv, x, dtype), train, dtype)
        return residual + y


class MultiresEncoder(nn.Module):
    """Reference EncoderV4 (v8) and EncoderV5 (v9): a 7x7 conv, then per
    level `d_i` strided (conv3x3 + BN + ReLU + 2x2 average pool)
    downsamplings and bottleneck blocks, the last emitting 2x channels
    (mean ++ log variance), unactivated. The next level continues from
    relu(mean). v9 adds a ReLU after each bottleneck block but the last
    and, in sets of >= 3 downsamplings, `mid_res` blocks (each followed by
    a ReLU) after the second one."""

    def __init__(self, cfg: AutoencoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        counts = cfg.downsampling_layers_count
        initial = cfg.bottleneck_features // (2 ** sum(counts))
        self.initial_conv = nn.Conv2d(cfg.input_features, initial, 7, bias=False, device=device)
        self.initial_bn = BatchNorm(initial, device=device)
        channels, cumulative = initial, 0
        for set_idx, downs in enumerate(counts):
            for i in range(downs):
                out = initial * 2 ** (cumulative + 1)
                self.add_module(f"down_{set_idx}_{i}", nn.Conv2d(channels, out, 3, bias=False, device=device))
                self.add_module(f"down_bn_{set_idx}_{i}", BatchNorm(out, device=device))
                channels, cumulative = out, cumulative + 1
                if self._mid_res(downs, i):
                    for b in range(cfg.bottleneck_blocks):
                        self.add_module(f"mid_res_{set_idx}_{b}", CycleGanResnetBlock(channels, channels, device))
            width = initial * 2 ** cumulative
            for b in range(cfg.bottleneck_blocks):
                out = 2 * width if b == cfg.bottleneck_blocks - 1 and cfg.variational else width
                self.add_module(f"bottleneck_{set_idx}_{b}", CycleGanResnetBlock(channels, out, device))
                channels = out
            channels //= 2 if cfg.variational else 1

    def _mid_res(self, downs: int, i: int) -> bool:
        return self.cfg.variant == "v9" and downs >= 3 and i == 1

    def forward(self, x: torch.Tensor, train: bool = False, remat: bool = False) -> List[torch.Tensor]:
        """:param x: (N, input_features, H, W). :return: per-level NCHW
        (mean ++ log variance), level 0 at the highest resolution."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        deep = cfg.variant == "v9"

        def initial(x):
            y = conv(self.initial_conv, reflect_pad_hw(x.to(dtype), 3), dtype)
            return torch.relu(self.initial_bn(y, train, dtype))

        def down(y, set_idx, i):
            y = conv(getattr(self, f"down_{set_idx}_{i}"), reflect_pad_hw(y.to(dtype), 1), dtype)
            return F.avg_pool2d(torch.relu(getattr(self, f"down_bn_{set_idx}_{i}")(y, train, dtype)), 2)

        def block(y, name, relu):
            y = getattr(self, name)(y, train, dtype)
            return torch.relu(y) if relu else y

        y = _region(remat, initial, x)
        outputs = []
        for set_idx, downs in enumerate(cfg.downsampling_layers_count):
            for i in range(downs):
                y = _region(remat, down, y, set_idx, i)
                if self._mid_res(downs, i):
                    for b in range(cfg.bottleneck_blocks):
                        y = _region(remat, block, y, f"mid_res_{set_idx}_{b}", True)
            for b in range(cfg.bottleneck_blocks):
                y = _region(remat, block, y, f"bottleneck_{set_idx}_{b}", deep and b != cfg.bottleneck_blocks - 1)
            outputs.append(y)
            y = torch.relu(y[:, : y.shape[1] // 2])
        return outputs


class MultiresDecoder(nn.Module):
    """Reference DecoderV6 (the v8 autoencoder) and DecoderV7 (v9): from the
    lowest-resolution latent upward, bottleneck blocks, bilinear-upsample
    convs and skip concatenation of the next level's latent, then a 7x7
    conv + sigmoid. v9 adds a ReLU after each bottleneck block and, in sets
    of 3 or more upsamplings, `mid_res` blocks (each followed by a ReLU)
    after the second-to-last upsampling."""

    def __init__(self, cfg: AutoencoderConfig, device=None):
        super().__init__()
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
                self.add_module(f"up_bn_{set_idx}_{i}", BatchNorm(initial * mult // 2, device=device))
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

    def forward(self, encoded_levels: List[torch.Tensor], train: bool = False, remat: bool = False) -> torch.Tensor:
        """:param encoded_levels: per-level NCHW latents, level 0 at the
        highest resolution. :return: (N, input_features, H, W) f32 in [0, 1]."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        deep = cfg.variant == "v9"

        def block(y, name, relu):
            y = getattr(self, name)(y, train, dtype)
            return torch.relu(y) if relu else y

        def up(y, set_idx, i):
            y = conv(getattr(self, f"up_{set_idx}_{i}"), reflect_pad_hw(upsample2x_bilinear(y.to(dtype)), 1), dtype)
            return torch.relu(getattr(self, f"up_bn_{set_idx}_{i}")(y, train, dtype))

        def final(y):
            return torch.sigmoid(conv(self.final_conv, reflect_pad_hw(y.to(dtype), 3), dtype).to(torch.float32))

        y = encoded_levels[-1]
        reversed_counts = list(reversed(cfg.downsampling_layers_count))
        for set_idx, downs in enumerate(reversed_counts):
            for b in range(cfg.bottleneck_blocks):
                y = _region(remat, block, y, f"bottleneck_{set_idx}_{b}", deep)
            for i in range(downs):
                y = _region(remat, up, y, set_idx, i)
                if self._mid_res(downs, i):
                    for b in range(cfg.bottleneck_blocks):
                        y = _region(remat, block, y, f"mid_res_{set_idx}_{b}", True)
            if set_idx != len(reversed_counts) - 1:
                skip = encoded_levels[-set_idx - 2]
                y = torch.cat([y, skip], dim=1)
        return _region(remat, final, y)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MultiresAutoencoder(nn.Module):
    """The VAE (`encoder` and `decoder`, the flax tree's names): `encode`,
    `sample`, `decode`, and `forward`, the variational path of phase 1.

    Seeded from `seed`, the decoder first, so that its weights are those of
    a decoder seeded alone (the play path's)."""

    def __init__(self, cfg: AutoencoderConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.decoder = MultiresDecoder(cfg, device=device)
        self.encoder = MultiresEncoder(cfg, device=device)
        initialize_(self, torch.Generator().manual_seed(seed))
        self.eval()

    def encode(self, observations: torch.Tensor, train: bool = False, remat: bool = False) -> List[torch.Tensor]:
        """:param observations: (N, H, W, input_features).
        :return: per-level (N, H/s, W/s, 2F) NHWC (mean ++ log variance)."""
        return [_nhwc(level) for level in self.encoder(_nchw(observations), train, remat)]

    def decode(self, encoded_levels: List[torch.Tensor], train: bool = False, remat: bool = False) -> torch.Tensor:
        """:param encoded_levels: per-level (N, H/s, W/s, F) NHWC latents.
        :return: (N, H, W, input_features) reconstruction in [0, 1]. Eval
        mode runs without autograd."""
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            return _nhwc(self.decoder([_nchw(level) for level in encoded_levels], train, remat))

    @staticmethod
    def sample(mean: torch.Tensor, log_variance: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Reparameterized posterior sample from unit normal `noise`."""
        return noise * torch.sqrt(torch.exp(log_variance)) + mean

    def forward(self, observations: torch.Tensor, rng=None, train: bool = True, remat: bool = False) -> dict:
        """Encode, sample each level (its mean without `rng`; with it, one
        unit normal draw of the level's shape from the "sampling" stream,
        level by level, outside any rematerialized region) and decode.

        :return: {"reconstructed_observations": (N, H, W, C),
            "encoded_observations": per-level NHWC (mean ++ log variance)}.
        """
        encoded = self.encode(observations, train, remat)
        sampled = []
        for level in encoded:
            half = level.shape[-1] // 2
            mean, log_variance = level[..., :half], level[..., half:]
            if rng is None:
                sampled.append(mean)
            else:
                noise = rng.normal("sampling", mean.shape).to(device=mean.device, dtype=mean.dtype)
                sampled.append(self.sample(mean, log_variance, noise))
        return {"reconstructed_observations": self.decode(sampled, train, remat), "encoded_observations": encoded}
