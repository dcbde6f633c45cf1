"""Sinusoidal positional encodings with optional coarse-to-fine annealing.

Port of playableenvironments_tpu/models/encoding.py. Feature order:
[raw?, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...], each block
spanning all input dims.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def annealing_weights(
    octaves: int, step, num_steps: int, device=None
) -> torch.Tensor:
    """(octaves,) cosine coarse-to-fine weights: octave j fades in as
    step * octaves / num_steps crosses j. At step 0 every weight is 0."""
    alpha = torch.as_tensor(step, dtype=torch.float32, device=device) * octaves / num_steps
    indexes = torch.arange(octaves, dtype=torch.float32, device=alpha.device)
    clamped = math.pi * torch.clamp(alpha - indexes, 0.0, 1.0)
    return (1.0 - torch.cos(clamped)) / 2.0


def positional_encoding(
    x: torch.Tensor,
    octaves: int,
    append_original: bool,
    octave_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., d) -> (..., 2 * octaves * d [+ d]).

    :param octave_weights: optional (octaves,) annealing weights multiplying
        each octave's sin/cos block.
    """
    freqs = 2.0 ** torch.arange(octaves, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]  # (..., octaves, d)
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    if octave_weights is not None:
        enc = enc * octave_weights[:, None, None]
    enc = enc.reshape(x.shape[:-1] + (2 * octaves * x.shape[-1],))
    if append_original:
        enc = torch.cat([x, enc], dim=-1)
    return enc
