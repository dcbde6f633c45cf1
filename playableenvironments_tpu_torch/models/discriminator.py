"""Sequence discriminator for the phase-3 GAN.

Port of playableenvironments_tpu/models/discriminator.py: a spectral-
normalized Conv1d stack over the time axis, masked average pooling over
valid steps and a spectral-normalized linear logit head. The convolutions
stay library calls, as the JAX package leaves them to XLA.

The spectral norm has flax's semantics (flax.linen.SpectralNorm), which
torch.nn.utils.spectral_norm does not: every call runs one power iteration
from the stored `u` (1, out) over the weight reshaped to (-1, out) in
flax's kernel layout ((k, in, out) for a convolution); u and v are
detached and sigma, recomputed at every call, carries the gradient; the
bias is left as it is; eps is 1e-12; `u` and `sigma` are stored only when
`update_stats`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + _EPS)


def spectral_sigma(matrix: torch.Tensor, u: torch.Tensor):
    """One power iteration of flax's SpectralNorm on `matrix` (rows, out)
    from u (1, out): (sigma, differentiable in `matrix`; the new u)."""
    with torch.no_grad():
        v = _l2_normalize(u @ matrix.t())
        u_new = _l2_normalize(v @ matrix)
    return (v @ matrix @ u_new.t())[0, 0], u_new


class SequenceDiscriminator(nn.Module):
    """(bs, T, features) sequences and (bs, T) validity -> (bs,) logits.
    Layers `conv_i` (Conv1d, kernel 5, padding 2) and `final_fc`; each
    layer's power-iteration state in the buffers `{layer}_u`, `{layer}_sigma`."""

    def __init__(self, in_features: int, layers_count: int = 3, layers_width: int = 128, device=None):
        super().__init__()
        self.layer_names = [f"conv_{k}" for k in range(layers_count)] + ["final_fc"]
        for k in range(layers_count):
            self.add_module(f"conv_{k}", nn.Conv1d(in_features if k == 0 else layers_width, layers_width, 5,
                                                   padding=2, device=device))
        self.final_fc = nn.Linear(layers_width, 1, device=device)
        for name in self.layer_names:
            out = getattr(self, name).weight.shape[0]
            self.register_buffer(f"{name}_u", torch.zeros(1, out, device=device))
            self.register_buffer(f"{name}_sigma", torch.ones((), device=device))

    def reset_special_(self, generator: torch.Generator) -> None:
        # flax draws the initial u from a standard normal.
        for name in self.layer_names:
            u = getattr(self, f"{name}_u")
            u.copy_(torch.randn(u.shape, generator=generator))

    def normalized_weight(self, name: str, update_stats: bool) -> torch.Tensor:
        """The layer's weight divided by its spectral norm estimate."""
        weight = getattr(self, name).weight
        # flax's kernel layout: Conv (k, in, out), Dense (in, out); reshaped to (-1, out).
        matrix = (weight.permute(2, 1, 0) if weight.dim() == 3 else weight.t()).reshape(-1, weight.shape[0])
        sigma, u_new = spectral_sigma(matrix, getattr(self, f"{name}_u"))
        if update_stats:
            with torch.no_grad():
                getattr(self, f"{name}_u").copy_(u_new)
                getattr(self, f"{name}_sigma").copy_(sigma.detach())
        return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, sequences: torch.Tensor, sequence_validity: torch.Tensor,
                update_sn_stats: bool = True) -> torch.Tensor:
        x = sequences.transpose(1, 2)
        for name in self.layer_names[:-1]:
            conv = getattr(self, name)
            x = torch.relu(F.conv1d(x, self.normalized_weight(name, update_sn_stats), conv.bias, padding=2))
        x = x.transpose(1, 2)
        mask = sequence_validity[..., None].to(x.dtype)
        pooled = (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1e-6)
        weight = self.normalized_weight("final_fc", update_sn_stats)
        return (pooled @ weight.t() + self.final_fc.bias)[..., 0]
