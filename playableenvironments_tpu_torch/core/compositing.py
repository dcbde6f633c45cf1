"""Volume-rendering weights.

Port of the part of playableenvironments_tpu/core/compositing.py that the
eval frame path uses (render/fast.py's per-object integration).
"""

from __future__ import annotations

import torch


def compositing_weights(alphas: torch.Tensor) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-10), an exclusive
    cumulative product over the last axis."""
    shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas[..., :-1] + 1e-10], dim=-1
    )
    return alphas * torch.cumprod(shifted, dim=-1)
