"""Phase-3 trainer: the action module over frozen scene encodings.

Port of playableenvironments_tpu/train/trainer_playable.py: `fused_step`
(one generator step, then one discriminator step, on one encoding), and
from a raw batch `encode_batch` (the frozen environment model's scene
encoding in eval mode, under no_grad), `step_with_batch` and
`init_state`. The losses: state reconstruction (rotations
compared in (sin, cos) space), action-direction KL, EMA-smoothed action
mutual information, entropy, ACMV (camera-relative too) and the GAN. The
per-object centroids and MI matrices, which the JAX TrainState keeps in
`extra`, are the trainer's own state here.

Two optimizers, as in the JAX trainer's masked optax pair: the generator's
Adam over every parameter but the discriminators', the discriminator's
over theirs, each with its own rate, weight decay and schedule count. The
generator's GAN loss has gradients with respect to the discriminators,
which the JAX generator transform zeroes; here they land in the
discriminators' `.grad`, which the discriminator step clears before its
own backward. One G+D pair advances the trainer's step once.

The frozen environment model is the trainer's, in eval mode and without
gradients; the JAX TrainState carries it in `extra["environment"]`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from playableenvironments_tpu_torch.config import ObjectIds
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.models.action import init_centroids
from playableenvironments_tpu_torch.models.layers import encode_rotation
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.train import losses
from playableenvironments_tpu_torch.train.state import Optimizer


@dataclass(frozen=True)
class PlayableLossWeights:
    """`playable_model_training.loss_weights`."""

    rotations_rec: float = 1.0
    translations_rec: float = 1.0
    style_rec: float = 1.0
    deformation_rec: float = 1.0
    entropy: float = 0.0
    action_directions_kl: float = 1e-4
    action_mutual_information: float = 0.15
    acmv: float = 0.0
    gan: float = 0.0


@dataclass(frozen=True)
class PlayableTrainingConfig:
    learning_rate: float = 5e-4
    lr_gamma: float = 0.926118
    lr_decay_iterations: int = 10000
    weight_decay: float = 0.0
    max_steps: int = 300000
    ground_truth_observations_start: int = 6
    ground_truth_observations_end: int = 6
    ground_truth_observations_steps: int = 16000
    observations_count: int = 9
    observations_count_start: int = 7
    observations_count_steps: int = 25000
    mutual_information_alpha: float = 0.2
    mutual_information_entropy_lambda: float = 1.0
    gan_mode: str = "lsgan"
    betas: Tuple[float, float] = (0.9, 0.999)
    discriminator_learning_rate: Optional[float] = None
    discriminator_weight_decay: Optional[float] = None
    use_camera_relative_acmv: bool = False
    acmv_rotation_axis: Optional[int] = None
    loss_weights: PlayableLossWeights = field(default_factory=PlayableLossWeights)

    def ground_truth_observations_at(self, step: int) -> int:
        """Linear annealing of the teacher-forced step count, in float32 and
        rounded half to even, as jnp.round does."""
        start, end = self.ground_truth_observations_start, self.ground_truth_observations_end
        fraction = np.clip(np.float32(step) / np.float32(self.ground_truth_observations_steps),
                           np.float32(0.0), np.float32(1.0))
        return int(np.round(np.float32(start) + np.float32(end - start) * fraction))

    def observations_count_at(self, step: int) -> int:
        """Annealed sequence length (drives the dataset's re-indexing)."""
        fraction = min(max(step / self.observations_count_steps, 0.0), 1.0)
        return int(round(self.observations_count_start
                         + (self.observations_count - self.observations_count_start) * fraction))


def masked_mse(a: torch.Tensor, b: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """MSE over the entries whose (truncated-to-length) validity is True."""
    v = validity[:, :a.shape[1]]
    extra = a.dim() - v.dim()
    return losses.masked_mean((a - b) ** 2, v.reshape(v.shape + (1,) * extra))


class PlayableTrainer:
    """The phase-3 G+D step over a PlayableEnvironmentModel."""

    def __init__(self, playable_model: PlayableEnvironmentModel, cfg: PlayableTrainingConfig,
                 environment_model=None):
        """:param environment_model: the frozen render.environment_model.
        EnvironmentModel whose scene encodings the batch paths train on
        (put in eval mode, its parameters out of autograd); None where the
        trainer only sees encodings."""
        self.playable_model = playable_model
        self.environment_model = environment_model
        if environment_model is not None:
            environment_model.eval().requires_grad_(False)
        self.cfg = cfg
        self.object_ids = ObjectIds(playable_model.scene)
        self.centroids: List[torch.Tensor] = []
        self.mi_matrices: List[torch.Tensor] = []
        named = list(playable_model.named_parameters())
        generator = [(n, p) for n, p in named if not n.startswith("discriminator")]
        discriminator = [(n, p) for n, p in named if n.startswith("discriminator")]
        self.optimizer = Optimizer(playable_model, cfg.learning_rate, cfg.lr_gamma, cfg.lr_decay_iterations,
                                   cfg.weight_decay, betas=tuple(cfg.betas), named_parameters=generator)
        self.discriminator_optimizer = None
        if playable_model.with_discriminators:
            lr = cfg.discriminator_learning_rate if cfg.discriminator_learning_rate is not None else cfg.learning_rate
            wd = cfg.discriminator_weight_decay if cfg.discriminator_weight_decay is not None else cfg.weight_decay
            self.discriminator_optimizer = Optimizer(playable_model, lr, cfg.lr_gamma, cfg.lr_decay_iterations, wd,
                                                     betas=tuple(cfg.betas), named_parameters=discriminator)

    @property
    def step(self) -> int:
        """The G+D pair count (the generator optimizer's)."""
        return self.optimizer.step_count

    def scene_animation_configs(self):
        return self.playable_model.scene.animation_models

    def init_state_from_encoding(self, encoding: SceneEncoding, seed: int = 0) -> None:
        """Fresh centroids (standard normal from `seed`) and MI matrices
        (uniform 1 / A^2) per animation model, on the model's device. The
        modules are built, and seeded, by the model itself; the encoding
        only has to lie on the same device."""
        device = next(self.playable_model.parameters()).device
        if encoding.object_rotations.device != device:
            raise ValueError(f"the encoding is on {encoding.object_rotations.device}, the model on {device}")
        self.init_extra(seed)

    def init_extra(self, seed: int = 0) -> None:
        """Fresh centroids (standard normal from `seed`) and MI matrices
        (uniform 1 / A^2) per animation model, on the model's device."""
        device = next(self.playable_model.parameters()).device
        self.centroids, self.mi_matrices = [], []
        for i, cfg in enumerate(self.scene_animation_configs()):
            generator = torch.Generator().manual_seed(seed * 1000 + i)
            self.centroids.append(init_centroids(generator, cfg.actions_count, cfg.action_space_dimension, device))
            self.mi_matrices.append(torch.full((cfg.actions_count, cfg.actions_count),
                                               1.0 / cfg.actions_count ** 2, device=device))

    def init_state(self, batch: Batch, seed: int = 0) -> None:
        """init_state_from_encoding on the frozen encoding of `batch`."""
        self.init_state_from_encoding(self.encode_batch(batch), seed)

    def encode_batch(self, batch: Batch) -> SceneEncoding:
        """The frozen scene encoding of a raw batch: the environment model
        in eval mode (running statistics, no style shuffle, no draw) under
        no_grad, on the playable model's device. Not inference_mode: the
        generator's backward saves the encoding."""
        if self.environment_model is None:
            raise ValueError("encode_batch needs the trainer's environment_model")
        device = next(self.playable_model.parameters()).device
        with torch.no_grad():
            encoding, _ = self.environment_model.compute_scene_encoding(
                *batch.to(device).environment_model_args(), shuffle_style=False, train=False,
            )
        return encoding

    def _per_object_centroids(self, per_model: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-animation-model values (centroids) mapped onto the dynamic
        objects, as the playable model maps its animation models
        (`animation_indexes`: one per dynamic object where the scene has one
        for each)."""
        return [per_model[k] for k in self.playable_model.animation_indexes]

    def compute_losses(self, encoding: SceneEncoding, rng, step: int,
                       update_stats: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict, List[Dict]]:
        """The generator pass: (loss, metrics, new extras {centroids,
        mi_matrices} per animation model, results). Updates the action
        networks' running statistics in place (the JAX function returns
        them) unless `update_stats` is False."""
        w = self.cfg.loss_weights
        model = self.playable_model
        results = model.animate(encoding, self.cfg.ground_truth_observations_at(step),
                                self._per_object_centroids(self.centroids), rng, update_stats)
        metrics: Dict[str, torch.Tensor] = {}
        total = encoding.object_rotations.new_zeros(())
        new_centroids, new_mi = list(self.centroids), list(self.mi_matrices)
        use_gan = model.with_discriminators and w.gan > 0.0
        if use_gan:
            fake_logits = model.discriminate(results, encoding, True, False)

        for dynamic_idx, res in enumerate(results):
            object_idx = self.object_ids.object_idx_by_dynamic_object_idx(dynamic_idx)
            anim_idx = model.animation_indexes[dynamic_idx]
            prefix = f"object_{object_idx}_"
            validity = res["sequence_validity"]
            rot_rec = masked_mse(encode_rotation(res["reconstructed_object_rotations"]),
                                 encode_rotation(encoding.object_rotations[..., object_idx, :]), validity)
            trans_rec = masked_mse(res["reconstructed_object_translations"],
                                   encoding.object_translations[..., object_idx, :], validity)
            style_rec = masked_mse(res["reconstructed_object_style"], encoding.object_style[..., object_idx, :],
                                   validity)
            deform_rec = masked_mse(res["reconstructed_object_deformation"],
                                    encoding.object_deformation[..., object_idx, :], validity)
            entropy = losses.entropy_logits(res["action_logits"])
            directions_kl = losses.kl_gaussian(res["action_directions_distribution"])
            mi_loss, new_mi[anim_idx] = losses.mutual_information_loss(
                torch.softmax(res["action_logits"], dim=-1), torch.softmax(res["reconstructed_action_logits"], dim=-1),
                lamb=self.cfg.mutual_information_entropy_lambda, smoothing_matrix=self.mi_matrices[anim_idx],
                smoothing_alpha=self.cfg.mutual_information_alpha,
            )
            new_centroids[anim_idx] = res["estimated_action_centroids"]
            object_loss = (w.rotations_rec * rot_rec + w.translations_rec * trans_rec + w.style_rec * style_rec
                           + w.deformation_rec * deform_rec + w.entropy * entropy
                           + w.action_directions_kl * directions_kl + w.action_mutual_information * mi_loss)
            if w.acmv > 0.0:
                translations = encoding.object_translations[..., object_idx, :]
                movements = translations[:, 1:] - translations[:, :-1]
                if self.cfg.use_camera_relative_acmv:
                    movements = losses.camera_relative_movements(movements, encoding.camera_rotations,
                                                                 self.cfg.acmv_rotation_axis)
                mask = validity[:, 1:][..., None].to(movements.dtype)
                probs = torch.softmax(res["action_logits"], dim=-1)
                acmv = losses.acmv_loss(movements * mask, probs * mask)
                object_loss = object_loss + w.acmv * acmv
                metrics[prefix + "acmv_loss"] = acmv
            if use_gan:
                gan_g = losses.gan_loss(fake_logits[dynamic_idx], True, self.cfg.gan_mode)
                object_loss = object_loss + w.gan * gan_g
                metrics[prefix + "gan_generator_loss"] = gan_g
            total = total + object_loss
            metrics[prefix + "rotations_reconstruction_loss"] = rot_rec
            metrics[prefix + "translations_reconstruction_loss"] = trans_rec
            metrics[prefix + "style_reconstruction_loss"] = style_rec
            metrics[prefix + "deformation_reconstruction_loss"] = deform_rec
            metrics[prefix + "entropy_loss"] = entropy
            metrics[prefix + "action_directions_kl_divergence_loss"] = directions_kl
            metrics[prefix + "action_mutual_information_loss"] = mi_loss
        metrics["loss"] = total
        return total, metrics, {"centroids": new_centroids, "mi_matrices": new_mi}, results

    def train_step(self, encoding: SceneEncoding, rng) -> Dict[str, torch.Tensor]:
        """The generator step: forward (running statistics updated), backward,
        the generator's Adam; the centroids and MI matrices move to the
        forward's. Returns the detached metrics."""
        self.playable_model.train()
        self.optimizer.zero_grad()
        loss, metrics, extra, _ = self.compute_losses(encoding, rng, self.step)
        loss.backward()
        self.optimizer.step()
        self.centroids, self.mi_matrices = extra["centroids"], extra["mi_matrices"]
        return {k: v.detach() for k, v in metrics.items()}

    def discriminator_step(self, encoding: SceneEncoding, rng, step: int) -> Dict[str, torch.Tensor]:
        """The discriminator step: `animate` with batch statistics but its
        running-statistics updates discarded and no gradient (the results are
        detached); real = the encoding, fake = the reconstruction; the real
        scoring updates the spectral-norm state and the fake scoring starts
        from it. `step` is the pre-generator count, so the teacher forcing
        matches the generator pass of the same pair."""
        model = self.playable_model
        with torch.no_grad():
            results = model.animate(encoding, self.cfg.ground_truth_observations_at(step),
                                    self._per_object_centroids(self.centroids), rng, update_stats=False)
        # Clears the generator pass's gradients on the discriminators.
        self.discriminator_optimizer.zero_grad()
        real = model.discriminate(results, encoding, False, True)
        fake = model.discriminate(results, encoding, True, True)
        loss = encoding.object_rotations.new_zeros(())
        for r, f in zip(real, fake):
            loss = loss + losses.gan_loss(r, True, self.cfg.gan_mode)
            loss = loss + losses.gan_loss(f, False, self.cfg.gan_mode)
        loss.backward()
        self.discriminator_optimizer.step()
        return {"discriminator_loss": loss.detach()}

    def step_with_batch(self, batch: Batch, rng) -> Dict[str, torch.Tensor]:
        """Encode once, then fused_step on the shared encoding. The JAX step
        splits its key three ways (environment, generator, discriminator);
        the eval-mode encoding draws nothing, so here the generator and
        discriminator passes draw from `rng` in that order."""
        return self.fused_step(self.encode_batch(batch), rng)

    def fused_step(self, encoding: SceneEncoding, rng) -> Dict[str, torch.Tensor]:
        """The generator step and, with discriminators, the discriminator
        step on one encoding; both passes draw from `rng`, in that order."""
        step = self.step
        metrics = self.train_step(encoding, rng)
        if self.playable_model.with_discriminators:
            metrics.update(self.discriminator_step(encoding, rng, step))
        return metrics
