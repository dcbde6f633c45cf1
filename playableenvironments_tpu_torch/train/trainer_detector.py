"""Detector training on the dataset's bounding-box annotations.

Port of playableenvironments_tpu/train/trainer_detector.py:
`DetectorTrainingConfig`, `DetectorTrainer` (one train step: targets
splatted at the heatmap's resolution, the CenterNet loss, AdamW with
optax's `adamw(learning_rate, weight_decay=...)` semantics through
train/state.py::Optimizer; the batch norms' running statistics follow
flax's momentum 0.99), its `detect_fn` (the evaluators' DetectorFn: one
frame -> the centers of the peaks at or above a threshold),
`evaluate_detection` (MDR/ADD of the eval-mode detector over annotated
batches) and `dataset_detection_batches`. The JAX trainer's state is the
trainer's own: the model's parameters and buffers, the optimizer's state
and step count (train/checkpointing.py saves and restores them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from playableenvironments_tpu_torch.eval.metrics import DetectionScore
from playableenvironments_tpu_torch.models.detector import (CenterNetDetector, decode_detections, detection_loss,
                                                             splat_gaussian_targets)
from playableenvironments_tpu_torch.train.state import Optimizer


@dataclass(frozen=True)
class DetectorTrainingConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    max_steps: int = 1000
    base_features: int = 32


class DetectorTrainer:
    """Trains a CenterNetDetector (seeded from `seed`) on (images, ltrb
    boxes, validity) batches."""

    def __init__(self, cfg: DetectorTrainingConfig, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.model = CenterNetDetector(cfg.base_features, device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        self.optimizer = Optimizer(self.model, cfg.learning_rate, weight_decay=cfg.weight_decay)

    @property
    def step(self) -> int:
        return self.optimizer.step_count

    def train_step(self, images: torch.Tensor, boxes: torch.Tensor, validity: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One optimization step.

        :param images: (B, H, W, 3) in [0, 1]; boxes (B, O, 4) normalized
            ltrb; validity (B, O) bool.
        :return: the detached losses."""
        self.model.train()
        self.optimizer.zero_grad()
        outputs = self.model(images.to(self.device), train=True)
        targets = splat_gaussian_targets(boxes.to(self.device), validity.to(self.device),
                                         tuple(outputs["heatmap"].shape[-2:]))
        losses = detection_loss(outputs, targets)
        losses["loss"].backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def detect(self, images: torch.Tensor, top_k: int = 8) -> Dict[str, torch.Tensor]:
        """decode_detections of the eval-mode detector on (B, H, W, 3)."""
        self.model.eval()
        return decode_detections(self.model(images.to(self.device), train=False), top_k=top_k)

    def detect_fn(self, top_k: int = 8, threshold: float = 0.3) -> Callable[[np.ndarray], np.ndarray]:
        """The evaluators' DetectorFn: one (H, W, 3) frame -> the (N, 2)
        normalized (row, col) centers of the peaks scoring >= `threshold`."""

        def detector(frame: np.ndarray) -> np.ndarray:
            out = self.detect(torch.from_numpy(np.asarray(frame, np.float32))[None], top_k)
            scores = out["scores"][0].cpu().numpy()
            return out["centers"][0].cpu().numpy()[scores >= threshold]

        return detector


def evaluate_detection(trainer: DetectorTrainer, batches: Iterable, max_batches: int = 8, top_k: int = 8,
                       threshold: float = 0.3, match_threshold: float = 0.1) -> Dict[str, float]:
    """Detection quality of the eval-mode detector over annotated batches,
    scored as MDR/ADD against the boxes' centers.

    :param batches: (images, boxes, validity) triples, e.g.
        `dataset_detection_batches(val_dataset, bs, shuffle=False)`.
    :return: {"missed_detection_rate", "average_detection_distance",
        "mean_detections_per_image"}."""
    score = DetectionScore(match_threshold)
    detections = images_seen = 0
    for batch_idx, (images, boxes, validity) in enumerate(batches):
        if batch_idx >= max_batches:
            break
        out = trainer.detect(torch.as_tensor(images), top_k)
        scores, centers = out["scores"].cpu().numpy(), out["centers"].cpu().numpy()
        for b in range(images.shape[0]):
            ref = np.asarray(boxes[b])[np.asarray(validity[b], bool)]
            # ltrb -> (row, col) centers, the DetectorFn's coordinates.
            ref_centers = np.stack([(ref[:, 1] + ref[:, 3]) / 2.0, (ref[:, 0] + ref[:, 2]) / 2.0], axis=-1)
            detected = centers[b][scores[b] >= threshold]
            score.update(ref_centers, detected)
            detections += len(detected)
            images_seen += 1
    results = score.results()
    results["mean_detections_per_image"] = detections / max(images_seen, 1)
    return results


def dataset_detection_batches(dataset, batch_size: int, shuffle: bool = True,
                              seed: int = 0) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(images, ltrb boxes, validity) of each batch of a MulticameraVideoDataset:
    the first observation of the first camera, its first three channels."""
    for batch in dataset.iterate_batches(batch_size, shuffle=shuffle, seed=seed):
        yield (batch.observations[:, 0, 0, ..., :3], batch.bounding_boxes[:, 0, 0],
               batch.bounding_boxes_validity[:, 0, 0])
