"""Phase-1 training-time evaluator.

Port of playableenvironments_tpu/eval/autoencoder_evaluator.py: a held-out
image batch through the autoencoder in eval mode (running statistics, the
posterior sampled from a fixed seed, as the JAX evaluator samples with
PRNGKey(0)), then a [ground truth | reconstruction] grid, the validation
reconstruction and KL losses and each level's latent statistics (mean |mean|,
mean exp(log variance)) through the Logger.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from playableenvironments_tpu_torch.train import losses


class AutoencoderEvaluator:
    """Periodic qualitative and quantitative phase-1 evaluation."""

    def __init__(self, trainer, val_images, max_grid_images: int = 4, rng_factory=None):
        """:param trainer: train.trainer_autoencoder.AutoencoderTrainer.
        :param val_images: (N, H, W, 3) held-out images in [0, 1].
        :param rng_factory: () -> the streams the posterior noise comes
            from, drawn afresh each evaluation (default RngStreams(0) on the
            trainer's device)."""
        from playableenvironments_tpu_torch.utils.random import RngStreams

        self.trainer = trainer
        self.val_images = torch.as_tensor(np.asarray(val_images)).to(trainer.device)
        self.max_grid_images = max_grid_images
        self.rng_factory = rng_factory or (lambda: RngStreams(0, trainer.device))

    @torch.no_grad()
    def statistics(self):
        """(reconstructions, stats) of the eval-mode forward."""
        out = self.trainer.model(self.val_images, self.rng_factory(), train=False)
        reconstructed = out["reconstructed_observations"]
        stats = {"val_reconstruction_loss": losses.image_reconstruction_loss(self.val_images, reconstructed)}
        for level_idx, level in enumerate(out["encoded_observations"]):
            features = level.shape[-1] // 2
            stats[f"val_kl_loss_level_{level_idx}"] = losses.spatial_kl_gaussian(level)
            stats[f"val_latent_abs_mean_level_{level_idx}"] = level[..., :features].abs().mean()
            stats[f"val_latent_variance_level_{level_idx}"] = torch.exp(level[..., features:]).mean()
        return reconstructed, stats

    def evaluate(self, logger, step: int) -> Dict[str, float]:
        """Log the grid and the statistics. :return: the statistics."""
        reconstructed, stats = self.statistics()
        scalars = {k: float(v) for k, v in stats.items()}
        logger.log(scalars, step)
        n = min(self.max_grid_images, self.val_images.shape[0])
        gt_row = np.concatenate(list(self.val_images[:n].float().cpu().numpy()), axis=1)
        rec_row = np.concatenate(list(np.clip(reconstructed[:n].float().cpu().numpy(), 0.0, 1.0)), axis=1)
        logger.log_image("autoencoder_reconstruction", np.concatenate([gt_row, rec_row], axis=0), step)
        return scalars
