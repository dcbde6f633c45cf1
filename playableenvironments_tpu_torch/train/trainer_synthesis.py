"""Phase-2 synthesis trainer: the loss and the train step of the
environment model.

Port of playableenvironments_tpu/train/trainer_synthesis.py on the
direct-ray path: reconstruction, ray-object distance, displacement
magnitude, per-dynamic-object opacity and sharpness, attention and
bounding-box losses, and the logged pose statistics. The divergence loss,
the consistency passes, the decoder path (`decode_patches`) and
rematerialization raise NotImplementedError when they are asked for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from playableenvironments_tpu_torch.config import ObjectIds
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.train import losses
from playableenvironments_tpu_torch.train.state import Optimizer
from playableenvironments_tpu_torch.utils.random import RNG_STREAMS, RngStreams

__all__ = ["LossWeights", "SynthesisTrainingConfig", "SynthesisTrainer", "RNG_STREAMS", "RngStreams"]


@dataclass(frozen=True)
class LossWeights:
    """Phase-2 loss weights (`training.loss_weights`). The perceptual,
    divergence and consistency losses are not ported: a non-zero weight
    raises."""

    reconstruction: float = 1.0
    perceptual: float = 0.0
    ray_object_distance: float = 0.0
    bounding_box: float = 0.0
    displacements_magnitude: float = 0.0
    divergence: float = 0.0
    opacity: float = 0.0
    attention: float = 0.0
    sharpness: float = 0.0
    sharpness_mean: float = 0.5
    sharpness_std: float = 0.15
    pose_consistency: float = 0.0
    keypoint_consistency: float = 0.0
    keypoint_opacity: float = 0.0


@dataclass(frozen=True)
class SynthesisTrainingConfig:
    learning_rate: float = 5e-4
    lr_gamma: float = 0.926118
    lr_decay_iterations: int = 10000
    weight_decay: float = 0.0
    max_steps: int = 300000
    samples_per_image: int = 144
    perturb: bool = True
    shuffle_style: bool = True
    patch_size: int = 0
    patch_strides: Tuple[int, ...] = ()
    loss_weights: LossWeights = field(default_factory=LossWeights)
    # Not ported yet; each raises when set (the decoder path's patch
    # sampling and autoencoder, rematerialization).
    decode_patches: bool = False
    remat: bool = False


class SynthesisTrainer:
    """Owns the optimizer of an EnvironmentModel and runs its phase-2 steps."""

    def __init__(self, model: EnvironmentModel, cfg: SynthesisTrainingConfig):
        unported = {
            "decode_patches": cfg.decode_patches,
            "patch_size": cfg.patch_size,
            "remat": cfg.remat,
            "perceptual loss": cfg.loss_weights.perceptual,
            "divergence loss": cfg.loss_weights.divergence,
            "pose consistency loss": cfg.loss_weights.pose_consistency,
            "keypoint consistency loss": cfg.loss_weights.keypoint_consistency,
            "keypoint opacity loss": cfg.loss_weights.keypoint_opacity,
        }
        for name, value in unported.items():
            if value:
                raise NotImplementedError(f"{name} is not ported yet")
        self.model = model
        self.cfg = cfg
        self.object_ids = ObjectIds(model.scene)
        self.optimizer = Optimizer(
            model, cfg.learning_rate, cfg.lr_gamma, cfg.lr_decay_iterations, cfg.weight_decay
        )

    @property
    def step(self) -> int:
        return self.optimizer.step_count

    def compute_losses(self, batch: Batch, rng, step) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
        """(loss, metrics, results) of one forward; updates the running
        statistics in place (the JAX function returns them)."""
        w = self.cfg.loss_weights
        results = self.model.forward_from_observations(
            *batch.environment_model_args(),
            samples_per_image=self.cfg.samples_per_image,
            perturb=self.cfg.perturb,
            patch_strides=self.cfg.patch_strides or None,
            shuffle_style=self.cfg.shuffle_style,
            step=step,
            train=True,
            rng=rng,
        )
        static_objects = self.object_ids.static_objects_count
        objects = self.object_ids.objects_count
        validity = batch.bounding_boxes_validity
        object_in_scene = validity.any(dim=2)
        sampled_observations = results["observations"]
        metrics: Dict[str, torch.Tensor] = {}
        sharpness_annealing = min(1.0, float(step) / self.cfg.max_steps)

        global_results = results["coarse"]["global"]
        reconstructed = global_results["integrated_features"]
        rec = losses.reconstruction_loss(sampled_observations, reconstructed)
        disp = global_results["integrated_displacements_magnitude"].mean()
        metrics["coarse_reconstruction_loss"] = rec
        metrics["coarse_displacements_magnitude_loss"] = disp
        metrics["coarse_divergence_loss"] = global_results["integrated_divergence"].mean()
        rod = losses.ray_object_distance_loss(
            sampled_observations, reconstructed, results["ray_object_distances"][..., static_objects:]
        )
        metrics["coarse_ray_object_distance_loss"] = rod
        total = w.reconstruction * rec + w.ray_object_distance * rod + w.displacements_magnitude * disp

        for object_idx in range(static_objects, objects):
            dyn_idx = self.object_ids.dynamic_object_idx_by_object_idx(object_idx)
            opacity = results["coarse"][f"object_{object_idx}"]["opacity"]
            op = losses.opacity_loss(opacity, validity[..., dyn_idx])
            sh = losses.sharpness_loss(opacity, validity[..., dyn_idx], w.sharpness_mean, w.sharpness_std)
            metrics[f"coarse_object_{object_idx}_opacity_loss"] = op
            metrics[f"coarse_object_{object_idx}_sharpness_loss"] = sh
            total = total + w.opacity * op + w.sharpness * sharpness_annealing * sh

        for object_idx in range(static_objects, objects):
            dyn_idx = self.object_ids.dynamic_object_idx_by_object_idx(object_idx)
            att = losses.attention_loss(results["object_attention"][object_idx], validity[:, :, 0, dyn_idx])
            metrics[f"object_{object_idx}_attention_loss"] = att
            total = total + w.attention * att

        if batch.bounding_boxes.shape[-2] > 0:
            bbox_loss, _ = losses.bounding_box_distance_loss(
                batch.bounding_boxes.detach(),
                results["reconstructed_bounding_boxes"][..., static_objects:, :],
                validity,
            )
            metrics["bounding_box_loss"] = bbox_loss
            total = total + w.bounding_box * bbox_loss

        for object_idx in range(static_objects, objects):
            dyn_idx = self.object_ids.dynamic_object_idx_by_object_idx(object_idx)
            translations = results["scene_encoding"].object_translations[..., object_idx, :]
            metrics[f"object_{object_idx}_translation_magnitude"] = losses.masked_mean(
                translations.detach().abs(), object_in_scene[..., dyn_idx][..., None]
            )
        metrics["loss"] = total
        return total, metrics, results

    def train_step(self, batch: Batch, rng) -> Dict[str, torch.Tensor]:
        """One optimization step: forward (running statistics updated),
        backward, Adam update at the current step's rate. Returns the
        detached metrics of the forward."""
        self.model.train()
        self.optimizer.zero_grad()
        loss, metrics, _ = self.compute_losses(batch, rng, self.step)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}
