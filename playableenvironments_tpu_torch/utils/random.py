"""Named random streams.

The JAX package threads one PRNG key per named stream ("ray_sampling",
"sampling", "alpha_noise", "style_shuffle", "divergence" in phase 2,
"action_sampling" and "gumbel" in phase 3) into each training step. The port draws from one seeded torch.Generator per stream
through this small interface; a caller that must reproduce given draws
(a parity test) passes any object with the same methods.
"""

from __future__ import annotations

from typing import Sequence

import torch

from playableenvironments_tpu_torch.utils.device import resolve_device

RNG_STREAMS = ("ray_sampling", "sampling", "alpha_noise", "style_shuffle", "divergence", "action_sampling", "gumbel")


class RngStreams:
    """One torch.Generator per stream on `device` (draws are made where they
    are used), seeded from `seed` and the stream's index. The default is the
    card, as for every entry point; without one this raises unless the
    caller asks for the CPU."""

    def __init__(self, seed: int, device="cuda"):
        self.device = resolve_device(device)
        self.generators = {
            name: torch.Generator(device=self.device).manual_seed(seed * len(RNG_STREAMS) + i)
            for i, name in enumerate(RNG_STREAMS)
        }

    def _draw(self, fn, stream: str, *args) -> torch.Tensor:
        return fn(*args, generator=self.generators[stream], device=self.device)

    def uniform(self, stream: str, shape: Sequence[int]) -> torch.Tensor:
        """Draws in [0, 1)."""
        return self._draw(torch.rand, stream, tuple(shape))

    def normal(self, stream: str, shape: Sequence[int]) -> torch.Tensor:
        return self._draw(torch.randn, stream, tuple(shape))

    def randint(self, stream: str, high: int, shape: Sequence[int]) -> torch.Tensor:
        """Integers in [0, high)."""
        return self._draw(torch.randint, stream, high, tuple(shape))

    def permutation(self, stream: str, n: int) -> torch.Tensor:
        return self._draw(torch.randperm, stream, n)

    def gumbel(self, stream: str, shape: Sequence[int]) -> torch.Tensor:
        """Standard Gumbel draws, -log(-log(u)) with u uniform in [tiny, 1)."""
        u = self.uniform(stream, shape).clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))
