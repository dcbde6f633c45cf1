"""Layers shared by the port's models: masked batch norm and AdaIN, the
flax-semantics batch norm, pooling and the conv residual block, rotation
encoding, gumbel-softmax sampling and seeded initialization.

Port of playableenvironments_tpu/models/layers.py. Parameter and buffer
names follow the flax modules so that compat/from_flax.py maps one tree onto
the other by name. The conv modules take and return NCHW tensors (the object
encoders convert their NHWC inputs once).

Running statistics: both flax norms update them with the BIASED batch
variance and momentum m as `m * running + (1 - m) * batch` (m = 0.9 for
MaskedBatchNorm, flax nn.BatchNorm's 0.99 for BatchNorm). torch's
BatchNorm2d would use the unbiased variance and the opposite momentum
convention, so both updates are written out here, in place on the buffers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def encode_rotation(angles: torch.Tensor) -> torch.Tensor:
    """(..., k) angles -> (..., 2k) interleaved (sin, cos) pairs."""
    pairs = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1)
    return pairs.reshape(angles.shape[:-1] + (-1,))


def decode_rotation(encoded: torch.Tensor) -> torch.Tensor:
    """(..., 2k) interleaved (sin, cos) -> (..., k) angles via atan2."""
    pairs = encoded.reshape(encoded.shape[:-1] + (-1, 2))
    return torch.atan2(pairs[..., 0], pairs[..., 1])


def masked_moments(
    x: torch.Tensor, mask: Optional[torch.Tensor], dims: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance over `dims`, counting only elements where
    `mask` (x's shape without the feature axis, broadcastable) is True."""
    if mask is None:
        mean = x.mean(dim=dims)
        return mean, ((x - mean) ** 2).mean(dim=dims)
    m = mask[..., None].expand(x.shape).to(x.dtype)
    count = torch.clamp(m.sum(dim=dims), min=1e-6)
    mean = (x * m).sum(dim=dims) / count
    var = ((x - mean) ** 2 * m).sum(dim=dims) / count
    return mean, var


_FROZEN_STATISTICS = 0


@contextlib.contextmanager
def frozen_running_statistics():
    """Inside the `with`, train-mode norms normalize by their batch
    statistics as always but leave their running statistics as they are.
    A rematerialized region re-runs its forward in the backward
    (utils/remat.py), which would otherwise apply the momentum twice. A
    process-wide count, not a thread-local one: the recompute runs on the
    autograd engine's thread."""
    global _FROZEN_STATISTICS
    _FROZEN_STATISTICS += 1
    try:
        yield
    finally:
        _FROZEN_STATISTICS -= 1


def _update_running(running: torch.Tensor, batch: torch.Tensor, momentum: float) -> None:
    if _FROZEN_STATISTICS:
        return
    with torch.no_grad():
        running.mul_(momentum).add_(batch.detach() * (1.0 - momentum))


class MaskedBatchNorm(nn.Module):
    """Batch norm over every axis but the last, whose statistics ignore
    masked-out elements. Buffers `mean`/`var` hold the running statistics
    (momentum 0.9); `use_scale_bias` adds a learned `weight` (flax's
    `scale`) and `bias`.

    With batch statistics, `update_stats=False` leaves the running
    statistics as they are: the JAX trainer's discriminator pass runs the
    action networks in train mode and discards their updates."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5, use_scale_bias: bool = False,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        if use_scale_bias:
            self.weight = nn.Parameter(torch.ones(features, device=device))
            self.bias = nn.Parameter(torch.zeros(features, device=device))
        else:
            self.weight = self.bias = None

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, use_running_average: bool = False,
        update_stats: bool = True,
    ) -> torch.Tensor:
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, var = masked_moments(x, mask, tuple(range(x.dim() - 1)))
            if update_stats:
                _update_running(self.mean, mean, self.momentum)
                _update_running(self.var, var, self.momentum)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y


class AffineTransformAdaIn(nn.Module):
    """style -> Linear -> (scale, bias); output = MaskedBatchNorm(x) * scale
    + bias. The play loop folds the eval form into a per-ray scale/bias
    (ops/fused_nerf.py::fold_adain_stats)."""

    def __init__(self, features: int, style_features: int, device=None):
        super().__init__()
        self.features = features
        self.affine = nn.Linear(style_features, 2 * features, device=device)
        self.norm = MaskedBatchNorm(features, device=device)

    def reset_special_(self, generator: torch.Generator) -> None:
        # Scale head starts at 1, bias head at 0 (flax bias_init).
        with torch.no_grad():
            self.affine.bias[: self.features] = 1.0
            self.affine.bias[self.features :] = 0.0

    def forward(
        self,
        x: torch.Tensor,
        style: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        use_running_average: bool = False,
    ) -> torch.Tensor:
        scale, bias = torch.chunk(self.affine(style), 2, dim=-1)
        return self.norm(x, mask, use_running_average) * scale + bias


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over NCHW channels: E[x^2] - E[x]^2 variance
    (clipped at 0), epsilon 1e-5, momentum 0.99, scale and bias. As flax's
    `BatchNorm(dtype=...)`, the statistics and the normalization are taken
    in f32 (f64 for f64 inputs, the references of tests and chip_smoke.py)
    and only the output is rounded to `dtype` (default that precision)."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        dtype = dtype or x.dtype
        if train:
            dims = (0, 2, 3)
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            _update_running(self.running_mean, mean, self.momentum)
            _update_running(self.running_var, var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(dtype)


def gumbel_softmax(rng, logits: torch.Tensor, temperature: float = 1.0, hard: bool = True) -> torch.Tensor:
    """A differentiable sample of the categorical over the last axis, with
    a straight-through hard one-hot when `hard`. The gumbel noise comes from
    the caller's `gumbel` stream (utils.random)."""
    gumbels = rng.gumbel("gumbel", logits.shape).to(logits.device)
    y_soft = torch.softmax((logits + gumbels) / temperature, dim=-1)
    if not hard:
        return y_soft
    y_hard = F.one_hot(y_soft.argmax(dim=-1), logits.shape[-1]).to(logits.dtype)
    return y_hard + y_soft - y_soft.detach()


def avg_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Non-overlapping average pool of NCHW by `factor`, the window clamped
    to the input so that inputs smaller than the factor pool to size 1."""
    if factor == 1:
        return x
    window = (min(factor, x.shape[-2]), min(factor, x.shape[-1]))
    return F.avg_pool2d(x, window, stride=window)


def conv(in_features: int, features: int, kernel: int, stride: int = 1, padding: Optional[int] = None,
         device=None) -> nn.Conv2d:
    """A bias-free conv; `padding` None is flax "SAME" at stride 1
    (symmetric (kernel - 1) / 2 for the odd kernels used here)."""
    if padding is None:
        if stride != 1 or kernel % 2 == 0:
            raise ValueError("SAME padding is written out only for odd kernels at stride 1")
        padding = (kernel - 1) // 2
    return nn.Conv2d(in_features, features, kernel, stride=stride, padding=padding, bias=False, device=device)


class ResidualBlock(nn.Module):
    """conv3x3 -> avg_pool(df) -> BN -> LeakyReLU(0.2) -> conv3x3 -> BN, with a
    conv1x1 + avg_pool + BN skip when the shape changes; final LeakyReLU
    unless `drop_final_activation`."""

    def __init__(self, in_features: int, features: int, downsample_factor: int = 1,
                 drop_final_activation: bool = False, device=None):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.drop_final_activation = drop_final_activation
        self.conv1 = conv(in_features, features, 3, device=device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = conv(features, features, 3, device=device)
        self.bn2 = BatchNorm(features, device=device)
        self.has_skip = in_features != features or downsample_factor != 1
        if self.has_skip:
            self.skip_conv = conv(in_features, features, 1, device=device)
            self.skip_bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = avg_pool(self.conv1(x), self.downsample_factor)
        y = F.leaky_relu(self.bn1(y, train), 0.2)
        y = self.bn2(self.conv2(y), train)
        residual = x
        if self.has_skip:
            residual = self.skip_bn(avg_pool(self.skip_conv(x), self.downsample_factor), train)
        y = y + residual
        return y if self.drop_final_activation else F.leaky_relu(y, 0.2)


def initialize_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init of every Linear/Conv1d/Conv2d below `module`: normal weights of
    variance 1/fan_in (flax's lecun_normal scale), zero biases, BN at
    identity; then each submodule's own `reset_special_(generator)`, where it
    has one, for initializers that differ (AdaIN scale heads, the bender's
    near-zero output head)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in module.modules():
            if hasattr(m, "reset_special_"):
                m.reset_special_(generator)
    return module
