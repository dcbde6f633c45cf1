"""SceneEncoding: the compact per-frame scene state.

Port of playableenvironments_tpu/scene/encoding.py as a dataclass of
tensors. The object axis comes before the per-object feature axis.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SceneEncoding:
    """Per-frame scene state; B = batch, T = observations, C = cameras,
    O = objects."""

    camera_rotations: torch.Tensor  # (B, T, C, 3)
    camera_translations: torch.Tensor  # (B, T, C, 3)
    focals: torch.Tensor  # (B, T, C)
    object_rotations: torch.Tensor  # (B, T, O, 3)
    object_translations: torch.Tensor  # (B, T, O, 3)
    object_style: torch.Tensor  # (B, T, O, style_features)
    object_deformation: torch.Tensor  # (B, T, O, deformation_features)
    object_in_scene: torch.Tensor  # (B, T, O) bool

    @property
    def objects_count(self) -> int:
        return self.object_rotations.shape[-2]

    def replace(self, **changes) -> "SceneEncoding":
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "SceneEncoding":
        """Apply `fn` to every field (e.g. a device move or a slice)."""
        return SceneEncoding(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def select_frame(self, frame_idx: int) -> "SceneEncoding":
        """Slice one observation index, keeping the T axis (size 1)."""
        return self.map(lambda x: x[:, frame_idx : frame_idx + 1])
