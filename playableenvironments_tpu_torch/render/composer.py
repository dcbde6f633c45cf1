"""SceneComposer: the per-object radiance-field weights of a scene.

Port of the parameter tree of playableenvironments_tpu/render/composer.py
(`params.composer.object_model_i`). Eval rendering reads it through
render/fast.py::render_rays_fast; the training-mode composer comes with the
phase-2 slice.
"""

from __future__ import annotations

import torch
from torch import nn

from playableenvironments_tpu_torch.config import SceneConfig
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.models.nerf import ObjectRadianceField
from playableenvironments_tpu_torch.utils.device import resolve_device


class SceneComposer(nn.Module):
    """`object_model_{i}`: one ObjectRadianceField per object model."""

    def __init__(self, scene: SceneConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.scene = scene
        for i, cfg in enumerate(scene.object_models):
            self.add_module(f"object_model_{i}", ObjectRadianceField(cfg, device=device))
        initialize_(self, torch.Generator().manual_seed(seed))
        self.eval()

    def object_model(self, model_idx: int) -> ObjectRadianceField:
        return getattr(self, f"object_model_{model_idx}")
