"""Phase-2 synthesis trainer: the loss and the train step of the
environment model.

Port of playableenvironments_tpu/train/trainer_synthesis.py on the
direct-ray path and on the published configs' decoder path
(`decode_patches`: one strided patch per image, its rendered features
decoded by the autoencoder and held against the ground-truth crop of the
patch's region; the autoencoder's own learning rate, held at 0 for
`frozen_autoencoder_steps`): for the coarse pass and, with `use_fine`
objects, the fine one, reconstruction, ray-object distance (direct path
only), displacement magnitude, the annealed divergence, per-dynamic-object
opacity and sharpness; attention and bounding-box losses, and the logged
pose statistics. The per-frame camera offsets train in a rate group of
their own (`camera_parameters_learning_rate`, 0 = frozen) when the model
has them. `remat` rematerializes the forward's regions (utils/remat.py).
The perceptual weight is read and, as in the JAX trainer, applied
nowhere. The consistency passes raise NotImplementedError when they are
asked for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from playableenvironments_tpu_torch.config import ObjectIds
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.render import sampling
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.train import losses
from playableenvironments_tpu_torch.train.state import Optimizer
from playableenvironments_tpu_torch.utils.random import RNG_STREAMS, RngStreams

__all__ = ["LossWeights", "SynthesisTrainingConfig", "SynthesisTrainer", "RNG_STREAMS", "RngStreams"]


@dataclass(frozen=True)
class LossWeights:
    """Phase-2 loss weights (`training.loss_weights`). `perceptual` is
    read and not applied, as in the JAX trainer; the consistency losses are
    not ported: a non-zero weight raises."""

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
    # The decoder path: decode the rendered feature patches and hold them
    # against the ground-truth crop of the patch's region.
    decode_patches: bool = False
    crop_to_patch: bool = True
    autoencoder_learning_rate: float = 1e-4
    frozen_autoencoder_steps: int = 0
    # The per-frame camera offsets' own rate (0.0: frozen), used when the
    # model has them.
    camera_parameters_learning_rate: float = 0.0
    # Rematerialize the forward's regions (utils/remat.py).
    remat: bool = False


class SynthesisTrainer:
    """Owns the optimizer of an EnvironmentModel and runs its phase-2 steps."""

    def __init__(self, model: EnvironmentModel, cfg: SynthesisTrainingConfig):
        unported = {
            "pose consistency loss": cfg.loss_weights.pose_consistency,
            "keypoint consistency loss": cfg.loss_weights.keypoint_consistency,
            "keypoint opacity loss": cfg.loss_weights.keypoint_opacity,
        }
        for name, value in unported.items():
            if value:
                raise NotImplementedError(f"{name} is not ported yet")
        if cfg.decode_patches and cfg.patch_size and not cfg.crop_to_patch:
            # The decoded output is a patch: it must be compared against the
            # matching crop, not the whole image.
            raise ValueError(
                "decode_patches with patch_size > 0 requires crop_to_patch=True (the decoded patch must be "
                "compared against the matching GT crop); set training.crop_to_patch or drop patch rendering"
            )
        self.model = model
        self.cfg = cfg
        self.object_ids = ObjectIds(model.scene)
        group_rates, freeze = {}, {}
        if model.enable_camera_offsets:
            # Only when the model has them, as in the JAX trainer.
            group_rates["camera_offsets"] = cfg.camera_parameters_learning_rate
        if cfg.decode_patches:
            group_rates["autoencoder"] = cfg.autoencoder_learning_rate
            freeze["autoencoder"] = cfg.frozen_autoencoder_steps
        self.optimizer = Optimizer(
            model, cfg.learning_rate, cfg.lr_gamma, cfg.lr_decay_iterations, cfg.weight_decay,
            group_learning_rates=group_rates, group_freeze_steps=freeze,
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
            patch_size=self.cfg.patch_size,
            patch_strides=self.cfg.patch_strides or None,
            shuffle_style=self.cfg.shuffle_style,
            step=step,
            train=True,
            compute_divergence=w.divergence > 0.0,
            decode_patches=self.cfg.decode_patches,
            rng=rng,
            remat=self.cfg.remat,
        )
        static_objects = self.object_ids.static_objects_count
        objects = self.object_ids.objects_count
        validity = batch.bounding_boxes_validity
        object_in_scene = validity.any(dim=2)
        sampled_observations = results["observations"]
        metrics: Dict[str, torch.Tensor] = {}
        divergence_annealing = (1.0 / 100.0) ** (1.0 - float(step) / self.cfg.max_steps)
        sharpness_annealing = min(1.0, float(step) / self.cfg.max_steps)

        target = None
        if self.cfg.decode_patches:
            target = batch.observations
            if self.cfg.crop_to_patch:
                finest_positions = sampling.split_strided_samples(
                    results["positions"], self.cfg.patch_size, self.cfg.patch_strides
                )[0]
                target = sampling.crop_region_from_patch_positions(
                    batch.observations, finest_positions, self.cfg.patch_size, self.cfg.patch_strides[0]
                )
        total = torch.zeros((), device=sampled_observations.device)
        for pass_name in ("coarse", "fine"):
            if pass_name not in results:
                continue
            global_results = results[pass_name]["global"]
            reconstructed = global_results["integrated_features"]
            if self.cfg.decode_patches:
                rec = losses.image_reconstruction_loss(target, global_results["reconstructed_observations"])
            else:
                rec = losses.reconstruction_loss(sampled_observations, reconstructed)
            disp = global_results["integrated_displacements_magnitude"].mean()
            div = global_results["integrated_divergence"].mean()
            metrics[f"{pass_name}_reconstruction_loss"] = rec
            metrics[f"{pass_name}_displacements_magnitude_loss"] = disp
            metrics[f"{pass_name}_divergence_loss"] = div
            total = total + w.reconstruction * rec
            if not self.cfg.decode_patches:
                # The decoder path renders feature patches, not RGB rays.
                rod = losses.ray_object_distance_loss(
                    sampled_observations, reconstructed, results["ray_object_distances"][..., static_objects:]
                )
                metrics[f"{pass_name}_ray_object_distance_loss"] = rod
                total = total + w.ray_object_distance * rod
            total = total + w.displacements_magnitude * disp
            total = total + w.divergence * divergence_annealing * div

            for object_idx in range(static_objects, objects):
                dyn_idx = self.object_ids.dynamic_object_idx_by_object_idx(object_idx)
                opacity = results[pass_name][f"object_{object_idx}"]["opacity"]
                op = losses.opacity_loss(opacity, validity[..., dyn_idx])
                sh = losses.sharpness_loss(opacity, validity[..., dyn_idx], w.sharpness_mean, w.sharpness_std)
                metrics[f"{pass_name}_object_{object_idx}_opacity_loss"] = op
                metrics[f"{pass_name}_object_{object_idx}_sharpness_loss"] = sh
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
