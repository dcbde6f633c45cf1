"""Training-time evaluator of phase 2: periodic qualitative renders.

Port of playableenvironments_tpu/eval/training_evaluator.py: on a
validation batch, the scene encoding is rendered back to full frames on
the ground-truth camera and on a novel (perturbed) camera through
eval.creators.FrameRenderer (B1 on the card), and a [ground truth |
reconstruction | novel view] grid and the reconstruction's MSE and PSNR
go through the Logger.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(images: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W, C) images resized to `size` (h, w) as
    jax.image.resize(..., "bilinear") does: half-pixel centres, and a
    triangle kernel widened by the scale where the image shrinks
    (antialiasing)."""
    lead = images.shape[:-3]
    flat = images.reshape((-1,) + images.shape[-3:]).permute(0, 3, 1, 2)
    out = F.interpolate(flat, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(lead + tuple(size) + (images.shape[-1],))


class TrainingEvaluator:
    """Qualitative render logging on a held-out batch, with the live model
    (its current weights) in eval mode."""

    def __init__(self, model, image_size, patch_strides: Optional[Sequence[int]] = None,
                 novel_rotation_offset: float = 0.05, novel_translation_offset: float = 0.5):
        """:param model: render.environment_model.EnvironmentModel (its own
        autoencoder decodes). :param image_size: (height, width)."""
        from playableenvironments_tpu_torch.eval.creators import FrameRenderer

        self.model = model
        self.image_size = tuple(image_size)
        self.patch_strides = list(patch_strides) if patch_strides else None
        self.novel_rotation_offset = novel_rotation_offset
        self.novel_translation_offset = novel_translation_offset
        self.renderer = FrameRenderer(model, getattr(model, "autoencoder", None), self.image_size,
                                      patch_strides=self.patch_strides)

    @torch.no_grad()
    def evaluate(self, batch, logger, step: int) -> float:
        """Render and log one grid. :return: the reconstruction's PSNR."""
        encoding = self.renderer.encode(batch)
        frames = self.renderer.render(encoding).cpu().numpy()  # (B, T, C, H, W, 3)
        rotations = encoding.camera_rotations.clone()
        rotations[..., 1] += self.novel_rotation_offset
        translations = encoding.camera_translations.clone()
        translations[..., 0] += self.novel_translation_offset
        novel = self.renderer.render(encoding.replace(camera_rotations=rotations,
                                                      camera_translations=translations)).cpu().numpy()

        gt = batch.observations[..., :3].float()
        if tuple(gt.shape[-3:-1]) != self.image_size:
            gt = resize_bilinear(gt, self.image_size)
        gt = gt.cpu().numpy()

        grid = np.concatenate([gt[0, 0, 0], frames[0, 0, 0], novel[0, 0, 0]], axis=1)
        logger.log_image("eval_render", grid, step)
        mse = float(np.mean((gt[:, :, :1] - frames[:, :, :1]) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        logger.log({"eval_psnr": psnr, "eval_mse": mse}, step)
        return psnr
