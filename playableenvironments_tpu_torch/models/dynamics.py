"""LSTM dynamics network with an explicit recurrent carry.

Port of playableenvironments_tpu/models/dynamics.py. The LSTM cells follow
flax's OptimizedLSTMCell: input projections ii/if/ig/io have no bias,
hidden projections hi/hf/hg/ho do, and the carry is (c, h). The initial
state is learnable.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from playableenvironments_tpu_torch.config import AnimationModelConfig
from playableenvironments_tpu_torch.core.transforms3d import (
    rotation_x,
    rotation_y,
    rotation_z,
)
from playableenvironments_tpu_torch.models.layers import decode_rotation, encode_rotation

Carry = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

_GATES = ("i", "f", "g", "o")


class OptimizedLSTMCell(nn.Module):
    """i = sigmoid(W_ii x + W_hi h + b_hi), f, g (tanh), o likewise;
    c' = f * c + i * g; h' = o * tanh(c'). Submodules are named as the flax
    parameters (`if` is reached with getattr)."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        for gate in _GATES:
            self.add_module(f"i{gate}", nn.Linear(in_features, features, bias=False, device=device))
            self.add_module(f"h{gate}", nn.Linear(features, features, device=device))

    def forward(self, carry, x):
        c, h = carry
        z = {g: getattr(self, f"i{g}")(x) + getattr(self, f"h{g}")(h) for g in _GATES}
        i, f, o = torch.sigmoid(z["i"]), torch.sigmoid(z["f"]), torch.sigmoid(z["o"])
        new_c = f * c + i * torch.tanh(z["g"])
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class DynamicsNetwork(nn.Module):
    """One-step state transition driven by a one-hot action and its
    variation. Input = sin/cos(rotations) ++ box-normalized translations ++
    style ++ deformation ++ action ++ action variation."""

    def __init__(self, cfg: AnimationModelConfig, bounding_box, device=None):
        super().__init__()
        self.cfg = cfg
        box = torch.as_tensor(bounding_box, dtype=torch.float32, device=device)
        self.register_buffer("box_size", box[:, 1] - box[:, 0], persistent=False)
        out = cfg.dynamics.output_features
        in_features = (
            6 + 3 + cfg.style_features + cfg.deformation_features
            + cfg.actions_count + cfg.action_space_dimension
        )
        for k in range(cfg.dynamics.layers_count):
            self.register_parameter(f"initial_hidden_{k}", nn.Parameter(torch.zeros(out, device=device)))
            self.register_parameter(f"initial_cell_{k}", nn.Parameter(torch.zeros(out, device=device)))
            self.add_module(f"lstm_{k}", OptimizedLSTMCell(in_features if k == 0 else out, out, device))
        self.backbone = nn.Linear(out, out, device=device)
        self.rotation_head = nn.Linear(out, 6, device=device)
        self.translation_head = nn.Linear(out, 3, device=device)
        self.style_head = nn.Linear(out, cfg.style_features, device=device)
        self.deformation_head = nn.Linear(out, cfg.deformation_features, device=device)

    def initial_carry(self, batch_size: int) -> Carry:
        """The learnable initial (c, h) of each cell, broadcast to the batch."""
        out = self.cfg.dynamics.output_features
        return tuple(
            (
                getattr(self, f"initial_cell_{k}").expand(batch_size, out),
                getattr(self, f"initial_hidden_{k}").expand(batch_size, out),
            )
            for k in range(self.cfg.dynamics.layers_count)
        )

    def forward(
        self,
        carry: Optional[Sequence],
        rotations: torch.Tensor,
        translations: torch.Tensor,
        style: torch.Tensor,
        deformation: torch.Tensor,
        action: torch.Tensor,
        action_variation: torch.Tensor,
    ):
        """:param carry: per cell (c, h), or None for the initial state.
        :param rotations, translations: (bs, 3); the rest (bs, F).
        :return: (new_carry, (next_rotations, next_translations, next_style,
                 next_deformation))."""
        if carry is None:
            carry = self.initial_carry(rotations.shape[0])
        x = torch.cat(
            [
                encode_rotation(rotations),
                translations / self.box_size,
                style,
                deformation,
                action,
                action_variation,
            ],
            dim=-1,
        )
        new_carry = []
        for k in range(self.cfg.dynamics.layers_count):
            cell_carry, x = getattr(self, f"lstm_{k}")(carry[k], x)
            new_carry.append(cell_carry)

        y = torch.relu(self.backbone(x))
        delta_rotations = decode_rotation(self.rotation_head(y))
        delta_translations = self.translation_head(y)
        next_style = self.style_head(y)
        next_deformation = self.deformation_head(y)

        axis = self.cfg.dynamics.rotation_axis
        if self.cfg.dynamics.force_rotations_zero:
            delta_rotations = delta_rotations * 0.0
        else:
            mask = torch.zeros(3, dtype=delta_rotations.dtype, device=delta_rotations.device)
            mask[axis] = 1.0
            delta_rotations = delta_rotations * mask
        next_rotations = rotations + delta_rotations

        # Object-frame deltas rotated into world by the current rotation
        # about the rotation axis.
        rot_fn = (rotation_x, rotation_y, rotation_z)[axis]
        world_deltas = torch.einsum("bij,bj->bi", rot_fn(rotations[..., axis]), delta_translations)
        next_translations = translations + world_deltas
        if self.cfg.dynamics.force_z_translations_zero:
            # The translation along the rotation axis is held at 0 (the JAX
            # package's force_rotation_axis_translation, which no caller sets).
            next_translations = next_translations.clone()
            next_translations[..., axis] = 0.0

        return tuple(new_carry), (next_rotations, next_translations, next_style, next_deformation)
