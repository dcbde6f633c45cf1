"""PlayableEnvironmentModel: the per-object action modules over scene
encodings, as far as the interactive play loop needs them.

Port of playableenvironments_tpu/render/playable_model.py's
`dynamics_step`. Phase-3 training (`animate`, the discriminators) comes with
the phase-3 slice.
"""

from __future__ import annotations

import torch
from torch import nn

from playableenvironments_tpu_torch.config import ObjectIds, SceneConfig
from playableenvironments_tpu_torch.models.action import ObjectAnimationModel
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.utils.device import resolve_device


class PlayableEnvironmentModel(nn.Module):
    """One ObjectAnimationModel (`animation_model_{k}`) per dynamic object
    model; dynamic objects sharing a model share its weights."""

    def __init__(self, scene: SceneConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.scene = scene
        self.object_ids = ObjectIds(scene)
        for anim_idx, cfg in enumerate(scene.animation_models):
            model_idx = self.object_ids.static_models_count + anim_idx
            box = scene.object_models[model_idx].bounding_box
            self.add_module(
                f"animation_model_{anim_idx}", ObjectAnimationModel(cfg, box, device=device)
            )
        initialize_(self, torch.Generator().manual_seed(seed))
        self.eval()

    @torch.no_grad()
    def dynamics_step(
        self,
        dynamic_idx: int,
        carry,
        rotations: torch.Tensor,
        translations: torch.Tensor,
        style: torch.Tensor,
        deformation: torch.Tensor,
        action_one_hot: torch.Tensor,
        action_variation: torch.Tensor,
    ):
        """One interactive dynamics step for one dynamic object; `carry` None
        starts from the learned initial state.

        :return: (new_carry, (rotations, translations, style, deformation)).
        """
        anim_idx = self.object_ids.animation_model_idx_by_dynamic_object_idx(dynamic_idx)
        module = getattr(self, f"animation_model_{anim_idx}")
        return module.dynamics_network(
            carry, rotations, translations, style, deformation,
            action_one_hot, action_variation,
        )
