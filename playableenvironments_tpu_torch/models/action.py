"""Action module: the action posterior network, EMA action centroids and the
per-object animation model (action inference and the autoregressive
dynamics rollout).

Port of playableenvironments_tpu/models/action.py. The centroids are
explicit state (functions take the current centroids and return updated
ones); posterior and gumbel sampling draw from the caller's random streams
(`action_sampling`, `gumbel`; utils.random). The rollout goes through the
fused rollout op (ops/fused_rollout.py: kernels B4/B5 on the card), as the
JAX model does outside its parameter initialization.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from playableenvironments_tpu_torch.config import AnimationModelConfig
from playableenvironments_tpu_torch.models.dynamics import DynamicsNetwork
from playableenvironments_tpu_torch.models.layers import MaskedBatchNorm, encode_rotation, gumbel_softmax
from playableenvironments_tpu_torch.ops import fused_rollout as fr


class ActionNetwork(nn.Module):
    """Per-transition action posterior: states (sin/cos rotations ++
    box-normalized translations) -> masked-BN MLP -> Gaussian state
    posterior (mean, log variance); action directions are successor minus
    predecessor state distributions; `final_fc` maps the sampled directions
    to action logits. (The JAX module's `use_deformation` input, which no
    model sets, is not ported.)"""

    def __init__(self, cfg: AnimationModelConfig, bounding_box, device=None):
        super().__init__()
        self.cfg = cfg
        box = torch.as_tensor(bounding_box, dtype=torch.float32, device=device)
        self.register_buffer("box_size", box[:, 1] - box[:, 0], persistent=False)
        width = cfg.action_network.layers_width
        for k in range(cfg.action_network.layers_count):
            # The first layer reads 6 sin/cos values and 3 translations.
            self.add_module(f"mlp_{k}", nn.Linear(9 if k == 0 else width, width, device=device))
            self.add_module(f"bn_{k}", MaskedBatchNorm(width, use_scale_bias=True, device=device))
        space = cfg.action_space_dimension
        self.mean_fc = nn.Linear(width, space, device=device)
        self.log_variance_fc = nn.Linear(width, space, device=device)
        self.final_fc = nn.Linear(space, cfg.actions_count, device=device)

    def forward(self, rotations, translations, object_in_scene, rng, update_stats: bool = True,
                use_running_average: bool = False) -> Dict[str, torch.Tensor]:
        """Train mode (batch statistics; `update_stats=False` keeps the
        running statistics as they are), or with `use_running_average` eval
        mode (the running statistics normalize, none moves).

        :param rotations, translations: (bs, T, 3); object_in_scene (bs, T) bool.
        :return: action_logits (bs, T-1, A), action_directions_distribution
            (bs, T-1, 2, S), sampled_action_directions (bs, T-1, S),
            action_states_distribution (bs, T, 2, S), sampled_action_states
            (bs, T, S)."""
        x = torch.cat([encode_rotation(rotations), translations / self.box_size], dim=-1)
        for k in range(self.cfg.action_network.layers_count):
            x = getattr(self, f"mlp_{k}")(x)
            x = torch.relu(getattr(self, f"bn_{k}")(x, object_in_scene, use_running_average, update_stats))
        states_mean = self.mean_fc(x)
        states_log_variance = self.log_variance_fc(x)
        noise = rng.normal("action_sampling", states_mean.shape).to(states_mean.device)
        sampled_states = noise * torch.exp(states_log_variance * 0.5) + states_mean
        # Difference distribution: mean difference, variance sum.
        directions_mean = states_mean[:, 1:] - states_mean[:, :-1]
        directions_variance = torch.exp(states_log_variance[:, 1:]) + torch.exp(states_log_variance[:, :-1])
        direction_noise = rng.normal("action_sampling", directions_mean.shape).to(states_mean.device)
        sampled_directions = direction_noise * torch.sqrt(directions_variance) + directions_mean
        return {
            "action_logits": self.final_fc(sampled_directions),
            "action_directions_distribution": torch.stack(
                [directions_mean, torch.log(directions_variance)], dim=-2),
            "sampled_action_directions": sampled_directions,
            "action_states_distribution": torch.stack([states_mean, states_log_variance], dim=-2),
            "sampled_action_states": sampled_states,
        }


# ---------------------------------------------------------------------------
# Centroids (explicit EMA state)
# ---------------------------------------------------------------------------


def init_centroids(generator: torch.Generator, actions_count: int, space_dimension: int, device=None) -> torch.Tensor:
    """Random-normal initial centroids (A, S)."""
    return torch.randn(actions_count, space_dimension, generator=generator).to(device)


def update_centroids(centroids: torch.Tensor, directions_distribution: torch.Tensor,
                     action_probabilities: torch.Tensor, validity: torch.Tensor, alpha: float) -> torch.Tensor:
    """EMA update of the per-action centroids (A, S) from the
    assignment-weighted direction means over valid transitions; detached."""
    means = directions_distribution[..., 0, :].reshape(-1, centroids.shape[1])
    probs = action_probabilities.reshape(-1, centroids.shape[0])
    probs = probs * validity.reshape(-1, 1).to(means.dtype)
    estimate = (probs.t() @ means) / (probs.sum(dim=0)[:, None] + 1e-8)
    return (centroids * (1.0 - alpha) + estimate * alpha).detach()


def compute_variations(centroids: torch.Tensor, points: torch.Tensor, assignments: torch.Tensor) -> torch.Tensor:
    """Variation of each point (..., S) from its assignment-weighted
    (..., A) centroid."""
    diffs = points[..., None, :] - centroids
    return torch.sum(assignments[..., None] * diffs, dim=-2)


def compute_sequence_validity(object_in_scene: torch.Tensor) -> torch.Tensor:
    """valid_t = AND of in_scene_0..t along axis 1."""
    return torch.cumprod(object_in_scene.to(torch.int32), dim=1).to(torch.bool)


# ---------------------------------------------------------------------------
# Animation model
# ---------------------------------------------------------------------------


def rollout_config(cfg: AnimationModelConfig, bounding_box) -> fr.RolloutConfig:
    """The fused rollout's static configuration for one animation model (the
    rotation-axis translation is held at 0 when forced, as no model of the
    JAX package overrides it)."""
    return fr.RolloutConfig(
        rotation_axis=cfg.dynamics.rotation_axis,
        force_rotations_zero=cfg.dynamics.force_rotations_zero,
        force_axis_translation=0.0 if cfg.dynamics.force_z_translations_zero else None,
        box_size=tuple(float(hi - lo) for lo, hi in bounding_box),
    )


class ObjectAnimationModel(nn.Module):
    """Action inference, centroid variations and the autoregressive dynamics
    rollout for one dynamic object model, in train mode or, with
    `use_running_average`, in the evaluators' eval mode."""

    def __init__(self, cfg: AnimationModelConfig, bounding_box, device=None):
        super().__init__()
        self.cfg = cfg
        self.rollout_cfg = rollout_config(cfg, bounding_box)
        self.action_network = ActionNetwork(cfg, bounding_box, device=device)
        self.dynamics_network = DynamicsNetwork(cfg, bounding_box, device=device)

    def compute_actions(self, rotations, translations, object_in_scene, rng, update_stats: bool = True,
                        use_running_average: bool = False) -> Dict[str, torch.Tensor]:
        """Action posterior plus gumbel-softmax action sampling."""
        out = self.action_network(rotations, translations, object_in_scene, rng, update_stats, use_running_average)
        log_probs = torch.log_softmax(out["action_logits"], dim=-1)
        out["sampled_actions"] = gumbel_softmax(rng, log_probs, self.cfg.gumbel_temperature, self.cfg.hard_gumbel)
        return out

    def rollout_dynamics(self, rotations, translations, style, deformation, actions, action_variations,
                         ground_truth_observations: int):
        """Autoregressive reconstruction with teacher forcing: step t sees the
        ground truth while t < ground_truth_observations (a host int), else
        its own last output. One fused rollout op (B4 forward, B5 backward on
        the card).

        :return: reconstructed (rotations, translations, style, deformation),
            each (bs, T, .)."""
        return fr.fused_rollout(
            self.rollout_cfg, fr.pack_dynamics_params(self.dynamics_network), rotations, translations, style,
            deformation, actions, action_variations, int(ground_truth_observations),
        )

    def forward(self, rotations, translations, style, deformation, object_in_scene, ground_truth_observations: int,
                centroids: torch.Tensor, rng, update_stats: bool = True, action_modifier=None,
                use_running_average: bool = False) -> Dict[str, torch.Tensor]:
        """The full forward. The centroids are updated (EMA, detached) before
        the variations, except with `use_running_average` (eval mode: the
        action network normalizes with its running statistics, and no
        centroid moves); `estimated_action_centroids` carries them back to
        the caller. `update_stats=False` keeps the action network's running
        statistics as they are. `action_modifier(sampled_actions,
        variations)` -> (actions, variations) changes what drives the
        rollout (eval.action_modifiers)."""
        sequence_validity = compute_sequence_validity(object_in_scene)
        actions_out = self.compute_actions(rotations, translations, object_in_scene, rng, update_stats,
                                           use_running_average)
        if not use_running_average:
            centroids = update_centroids(
                centroids, actions_out["action_directions_distribution"],
                torch.softmax(actions_out["action_logits"], dim=-1), sequence_validity[:, :-1],
                self.cfg.centroid_alpha,
            )
        sampled_actions = actions_out["sampled_actions"]
        action_variations = compute_variations(centroids, actions_out["sampled_action_directions"], sampled_actions)
        if action_modifier is not None:
            sampled_actions, action_variations = action_modifier(sampled_actions, action_variations)
        rec_rot, rec_trans, rec_style, rec_deform = self.rollout_dynamics(
            rotations, translations, style, deformation, sampled_actions, action_variations,
            ground_truth_observations,
        )
        # Actions re-inferred from the reconstruction (the MI loss's second view).
        rec_out = self.compute_actions(rec_rot, rec_trans, object_in_scene, rng, update_stats, use_running_average)
        return {
            "reconstructed_object_rotations": rec_rot,
            "reconstructed_object_translations": rec_trans,
            "reconstructed_object_style": rec_style,
            "reconstructed_object_deformation": rec_deform,
            "sampled_actions": sampled_actions,
            "action_logits": actions_out["action_logits"],
            "action_directions_distribution": actions_out["action_directions_distribution"],
            "sampled_action_directions": actions_out["sampled_action_directions"],
            "action_states_distribution": actions_out["action_states_distribution"],
            "sampled_action_states": actions_out["sampled_action_states"],
            "action_variations": action_variations,
            "reconstructed_action_logits": rec_out["action_logits"],
            "reconstructed_action_directions_distribution": rec_out["action_directions_distribution"],
            "reconstructed_sampled_action_directions": rec_out["sampled_action_directions"],
            "reconstructed_action_states_distribution": rec_out["action_states_distribution"],
            "reconstructed_sampled_action_states": rec_out["sampled_action_states"],
            "sequence_validity": sequence_validity,
            "estimated_action_centroids": centroids,
        }
