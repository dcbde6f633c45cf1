"""Action modifiers applied during evaluation rollouts.

Port of playableenvironments_tpu/eval/action_modifiers.py."""

from __future__ import annotations

import torch


def zero_variation_action_modifier(sampled_actions, action_variations):
    """Zero the sampled action variations (deterministic re-enactment)."""
    return sampled_actions, torch.zeros_like(action_variations)
