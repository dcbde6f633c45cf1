"""Layers shared by the port's models: eval-mode AdaIN, rotation encoding and
seeded initialization.

Port of the parts of playableenvironments_tpu/models/layers.py that the play
loop needs. Parameter and buffer names follow the flax modules so that
compat/from_flax.py maps one tree onto the other by name.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def encode_rotation(angles: torch.Tensor) -> torch.Tensor:
    """(..., k) angles -> (..., 2k) interleaved (sin, cos) pairs."""
    pairs = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1)
    return pairs.reshape(angles.shape[:-1] + (-1,))


def decode_rotation(encoded: torch.Tensor) -> torch.Tensor:
    """(..., 2k) interleaved (sin, cos) -> (..., k) angles via atan2."""
    pairs = encoded.reshape(encoded.shape[:-1] + (-1, 2))
    return torch.atan2(pairs[..., 0], pairs[..., 1])


class RunningMoments(nn.Module):
    """The running mean/var buffers of the flax MaskedBatchNorm (eval mode
    reads them only)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))


class AffineTransformAdaIn(nn.Module):
    """style -> Linear -> (scale, bias); output = BN(x) * scale + bias, with
    BN in eval mode (running statistics). Eval only: the play loop folds it
    into a per-ray scale/bias (ops/fused_nerf.py::fold_adain_stats)."""

    def __init__(self, features: int, style_features: int, device=None):
        super().__init__()
        self.features = features
        self.affine = nn.Linear(style_features, 2 * features, device=device)
        self.norm = RunningMoments(features, device=device)

    def reset_special_(self, generator: torch.Generator) -> None:
        # Scale head starts at 1, bias head at 0 (flax bias_init).
        with torch.no_grad():
            self.affine.bias[: self.features] = 1.0
            self.affine.bias[self.features :] = 0.0


def initialize_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init of every Linear/Conv2d below `module`: normal weights of
    variance 1/fan_in (flax's lecun_normal scale), zero biases, BN at
    identity; then each submodule's own `reset_special_(generator)`, where it
    has one, for initializers that differ (AdaIN scale heads, the bender's
    near-zero output head)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in module.modules():
            if hasattr(m, "reset_special_"):
                m.reset_special_(generator)
    return module
