"""Phase-1 trainer: the variational feature renderer (VAE) on plain images.

Port of playableenvironments_tpu/train/trainer_autoencoder.py: pixel MSE,
the spatial KL of every level's posterior and, with a perceptual weight,
the VGG19 perceptual L1 (the ground-truth branch without gradient); Adam
with the staircase decay. The VGG runs on seeded random weights unless
`vgg_weights_path` names a torchvision VGG19 checkpoint; it is frozen and
outside the optimizer, as the JAX trainer keeps its variables outside the
train state. Rematerialization (`remat`) raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from playableenvironments_tpu_torch.config import AutoencoderConfig
from playableenvironments_tpu_torch.models.autoencoder import MultiresAutoencoder
from playableenvironments_tpu_torch.train import losses
from playableenvironments_tpu_torch.train.state import Optimizer


@dataclass(frozen=True)
class AutoencoderTrainingConfig:
    learning_rate: float = 4e-4
    lr_gamma: float = 0.926118
    lr_decay_iterations: int = 10000
    weight_decay: float = 0.0
    max_steps: int = 300000
    reconstruction_lambda: float = 1.0
    perceptual_lambda: float = 0.0
    kl_lambda: float = 5e-6
    vgg_weights_path: str = ""
    remat: bool = False


class AutoencoderTrainer:
    """Owns a MultiresAutoencoder (seeded from `seed`), its optimizer and,
    with a perceptual weight, the frozen VGG19; runs phase-1 steps on
    (N, H, W, 3) images."""

    def __init__(self, ae_cfg: AutoencoderConfig, cfg: AutoencoderTrainingConfig, device="cuda", seed: int = 0):
        if cfg.remat:
            raise NotImplementedError("remat (rematerialization) is not ported yet")
        self.ae_cfg = ae_cfg
        self.cfg = cfg
        self.model = MultiresAutoencoder(ae_cfg, device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        self.vgg = None
        if cfg.perceptual_lambda > 0.0:
            from playableenvironments_tpu_torch.eval.perceptual import init_vgg19, load_torch_vgg_weights

            self.vgg = init_vgg19(device=self.device)
            if cfg.vgg_weights_path:
                load_torch_vgg_weights(cfg.vgg_weights_path, self.vgg)
        self.optimizer = Optimizer(self.model, cfg.learning_rate, cfg.lr_gamma, cfg.lr_decay_iterations,
                                   cfg.weight_decay)

    @property
    def step(self) -> int:
        return self.optimizer.step_count

    def compute_losses(self, images: torch.Tensor, rng) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
        """(loss, metrics, outputs) of one train-mode forward; updates the
        running statistics in place. The posterior noise comes from `rng`'s
        "sampling" stream (MultiresAutoencoder.forward)."""
        out = self.model(images, rng, train=True)
        reconstructed = out["reconstructed_observations"]
        rec = losses.image_reconstruction_loss(images, reconstructed)
        kl = torch.stack([losses.spatial_kl_gaussian(level) for level in out["encoded_observations"]]).mean()
        total = self.cfg.reconstruction_lambda * rec + self.cfg.kl_lambda * kl
        metrics = {"loss": total, "reconstruction_loss": rec, "kl_loss": kl}
        if self.vgg is not None:
            from playableenvironments_tpu_torch.eval.perceptual import perceptual_loss

            perceptual, _ = perceptual_loss(self.vgg, images, reconstructed, self.ae_cfg.compute_dtype)
            total = total + self.cfg.perceptual_lambda * perceptual
            metrics["perceptual_loss"] = perceptual
            metrics["loss"] = total
        return total, metrics, out

    def train_step(self, images: torch.Tensor, rng) -> Dict[str, torch.Tensor]:
        """One optimization step; returns the detached metrics."""
        self.model.train()
        self.optimizer.zero_grad()
        loss, metrics, _ = self.compute_losses(images.to(self.device), rng)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}
