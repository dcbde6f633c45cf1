"""Reflect padding of NCHW feature maps.

Port of playableenvironments_tpu/ops/padding.py::reflect_pad_hw. The JAX
module's custom backward is a TPU lowering fix; here it is F.pad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the two spatial dims of an (N, C, H, W) tensor by `pad`."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")
