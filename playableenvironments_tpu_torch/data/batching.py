"""Fixed-shape training batches.

Port of playableenvironments_tpu/data/batching.py: `Batch` as a dataclass
of tensors (NHWC observations, object axis before features) and `collate`,
which stacks dataset samples into a Batch of CPU tensors with the JAX
package's dtypes (float32 frames and cameras, bool validity, int32 frame,
video and action indexes); `Batch.to(device)` moves it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
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
    global_frame_indexes: torch.Tensor  # (B, T) int32
    video_frame_indexes: torch.Tensor  # (B, T) int32
    video_indexes: torch.Tensor  # (B,) int32
    actions: Optional[torch.Tensor] = None  # (B, T) int32
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


def collate(samples: Sequence[dict]) -> Batch:
    """Stack per-sample dicts (from data.dataset.MulticameraVideoDataset)
    into a Batch of CPU tensors."""

    def stack(key):
        return torch.from_numpy(np.stack([s[key] for s in samples]))

    optional = {}
    for key in ("actions", "keypoints", "keypoints_validity", "optical_flow"):
        if samples[0].get(key) is not None:
            optional[key] = stack(key)
    return Batch(
        observations=stack("observations"),
        camera_rotations=stack("camera_rotations"),
        camera_translations=stack("camera_translations"),
        focals=stack("focals"),
        bounding_boxes=stack("bounding_boxes"),
        bounding_boxes_validity=stack("bounding_boxes_validity"),
        global_frame_indexes=stack("global_frame_indexes"),
        video_frame_indexes=stack("video_frame_indexes"),
        video_indexes=torch.from_numpy(np.asarray([s["video_index"] for s in samples], np.int32)),
        **optional,
    )
