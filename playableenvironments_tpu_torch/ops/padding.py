"""Padding of channels-first feature maps: reflect padding, and the SAME
padding of flax convolutions and pools written out.

Port of playableenvironments_tpu/ops/padding.py::reflect_pad_hw (the JAX
module's custom backward is a TPU lowering fix; here it is F.pad), and
`pad_same`, the padding XLA gives a SAME window (lax.padtype_to_pads).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


def reflect_pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the two spatial dims of an (N, C, H, W) tensor by `pad`."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def _same_pads(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int],
              dilation: Sequence[int]) -> List[int]:
    """(before, after) per spatial axis of a SAME window, as XLA pads it:
    out = ceil(size / stride), the total pad max((out - 1) stride +
    (kernel - 1) dilation + 1 - size, 0), its smaller half before. At stride
    2 on an even side the pad is asymmetric (a 7-wide kernel: 2 before, 3
    after), which no symmetric `padding=` of a torch convolution gives."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, strides, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in pads for p in pair]


def pad_same(x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int], dilation: Optional[Sequence[int]] = None,
             value: float = 0.0) -> torch.Tensor:
    """Pad the trailing spatial axes of an (N, C, *spatial) tensor for a
    SAME window of `kernel` at `strides` (and `dilation`), with `value`
    (0 before a convolution, -inf before a max pool); the window then runs
    unpadded."""
    spatial = x.shape[2:]
    dilation = dilation or [1] * len(spatial)
    pads = _same_pads(spatial, kernel, strides, dilation)
    # F.pad takes the last axis first.
    flat = [p for axis in reversed(range(len(spatial))) for p in pads[2 * axis:2 * axis + 2]]
    return F.pad(x, flat, value=value) if any(flat) else x
