"""Fixed-shape training batches.

Port of the `Batch` of playableenvironments_tpu/data/batching.py as a
dataclass of tensors (NHWC observations, object axis before features).
`collate` (stacking dataset samples) comes with the data slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class Batch:
    """One training batch. B = batch, T = observations, C = cameras,
    O = dynamic objects, K = observation stacking."""

    observations: torch.Tensor  # (B, T, C, H, W, 3 K) float32 in [0, 1]
    camera_rotations: torch.Tensor  # (B, T, C, 3)
    camera_translations: torch.Tensor  # (B, T, C, 3)
    focals: torch.Tensor  # (B, T, C)
    bounding_boxes: torch.Tensor  # (B, T, C, O, 4) normalized ltrb
    bounding_boxes_validity: torch.Tensor  # (B, T, C, O) bool
    global_frame_indexes: torch.Tensor  # (B, T) int
    video_frame_indexes: torch.Tensor  # (B, T) int
    video_indexes: torch.Tensor  # (B,) int
    actions: Optional[torch.Tensor] = None  # (B, T) int
    keypoints: Optional[torch.Tensor] = None  # (B, T, C, KP, 3, O)
    keypoints_validity: Optional[torch.Tensor] = None
    optical_flow: Optional[torch.Tensor] = None  # (B, T, C, H, W, 2)

    @property
    def batch_size(self) -> int:
        return self.observations.shape[0]

    def environment_model_args(self):
        """Positional arguments of EnvironmentModel.forward_from_observations."""
        return (
            self.observations, self.camera_rotations, self.camera_translations, self.focals,
            self.bounding_boxes, self.bounding_boxes_validity, self.global_frame_indexes,
        )

    def to(self, device) -> "Batch":
        return Batch(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })
