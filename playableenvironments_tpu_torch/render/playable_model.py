"""PlayableEnvironmentModel: the per-object action modules (and, for phase-3
training, the sequence discriminators) over scene encodings.

Port of playableenvironments_tpu/render/playable_model.py: `animate`
(phase-3 forward), `discriminate` (GAN scoring), `dynamics_step` (the play
loop's step) and `_pad_time`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.config import ObjectIds, SceneConfig
from playableenvironments_tpu_torch.models.action import ObjectAnimationModel
from playableenvironments_tpu_torch.models.discriminator import SequenceDiscriminator
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.utils.device import resolve_device


class PlayableEnvironmentModel(nn.Module):
    """One ObjectAnimationModel (`animation_model_{k}`) per dynamic object
    model (dynamic objects sharing a model share its weights) and, with
    `with_discriminators`, one SequenceDiscriminator (`discriminator_{k}`)
    per animation model over the JAX model's default codes: translations,
    action probabilities and action directions. Weights are seeded from
    `seed`."""

    def __init__(self, scene: SceneConfig, with_discriminators: bool = False, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.scene = scene
        self.object_ids = ObjectIds(scene)
        self.with_discriminators = with_discriminators
        for anim_idx, cfg in enumerate(scene.animation_models):
            model_idx = self.object_ids.static_models_count + anim_idx
            box = scene.object_models[model_idx].bounding_box
            self.add_module(f"animation_model_{anim_idx}", ObjectAnimationModel(cfg, box, device=device))
        if with_discriminators:
            for anim_idx, cfg in enumerate(scene.animation_models):
                in_features = 3 + cfg.actions_count + cfg.action_space_dimension
                self.add_module(f"discriminator_{anim_idx}", SequenceDiscriminator(in_features, device=device))
        initialize_(self, torch.Generator().manual_seed(seed))
        self.eval()

    def _animation_model(self, dynamic_idx: int) -> ObjectAnimationModel:
        return getattr(self, f"animation_model_{self.object_ids.animation_model_idx_by_dynamic_object_idx(dynamic_idx)}")

    def animate(self, encoding, ground_truth_observations: int, centroids: Sequence[torch.Tensor], rng,
                update_stats: bool = True) -> List[Dict]:
        """Each dynamic object's animation model over its state sequence, in
        train mode.

        :param centroids: per dynamic object (A, S) EMA centroids.
        :param update_stats: False keeps the action networks' running
            statistics (the discriminator pass discards their update).
        :return: per dynamic object its result dict, with its updated
            `estimated_action_centroids`."""
        results = []
        for dynamic_idx in range(self.object_ids.dynamic_objects_count):
            object_idx = self.object_ids.object_idx_by_dynamic_object_idx(dynamic_idx)
            results.append(self._animation_model(dynamic_idx)(
                encoding.object_rotations[..., object_idx, :],
                encoding.object_translations[..., object_idx, :],
                encoding.object_style[..., object_idx, :],
                encoding.object_deformation[..., object_idx, :],
                encoding.object_in_scene[..., object_idx],
                ground_truth_observations, centroids[dynamic_idx], rng, update_stats,
            ))
        return results

    def discriminate(self, results: List[Dict], encoding, use_reconstructed: bool,
                     update_sn_stats: bool = True) -> List[torch.Tensor]:
        """Per-object (bs,) logits: real sequences from the encoding and the
        actions inferred from it, fake ones from the reconstruction."""
        logits = []
        for dynamic_idx, res in enumerate(results):
            object_idx = self.object_ids.object_idx_by_dynamic_object_idx(dynamic_idx)
            anim_idx = self.object_ids.animation_model_idx_by_dynamic_object_idx(dynamic_idx)
            steps = res["sequence_validity"].shape[1]
            prefix = "reconstructed_" if use_reconstructed else ""
            translations = (res["reconstructed_object_translations"] if use_reconstructed
                            else encoding.object_translations[..., object_idx, :])
            codes = [translations, _pad_time(torch.softmax(res[prefix + "action_logits"], dim=-1), steps),
                     _pad_time(res[prefix + "sampled_action_directions"], steps)]
            discriminator = getattr(self, f"discriminator_{anim_idx}")
            logits.append(discriminator(torch.cat(codes, dim=-1), res["sequence_validity"], update_sn_stats))
        return logits

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
        return self._animation_model(dynamic_idx).dynamics_network(
            carry, rotations, translations, style, deformation,
            action_one_hot, action_variation,
        )


def _pad_time(tensor: torch.Tensor, target_t: int) -> torch.Tensor:
    """Right-pad a (bs, T-1, F) tensor with zeros to (bs, target_t, F)."""
    pad = target_t - tensor.shape[1]
    if pad <= 0:
        return tensor
    return F.pad(tensor, (0, 0, 0, pad))
