"""The play loop's dynamics step as a function.

Port of playableenvironments_tpu/render/interactive.py: one dynamics step per
dynamic object, then the updated frame-0 encoding (with the
`use_initial_style` anti-drift option).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from playableenvironments_tpu_torch.config import ObjectIds
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding


def action_inputs(
    playable_model, actions: Sequence[int], device=None
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-dynamic-object (one_hot, zero-variation) pairs from action ints.
    Out-of-range indices clamp to the object's valid range."""
    one_hots, variations = [], []
    for dynamic_idx, action in enumerate(actions):
        anim_cfg = playable_model.scene.animation_models[playable_model.animation_indexes[dynamic_idx]]
        action = max(0, min(int(action), anim_cfg.actions_count - 1))
        index = torch.tensor([action], device=device)
        one_hots.append(F.one_hot(index, anim_cfg.actions_count).to(torch.float32))
        variations.append(torch.zeros((1, anim_cfg.action_space_dimension), device=device))
    return tuple(one_hots), tuple(variations)


@torch.no_grad()
def interactive_step(
    playable_model,
    encoding: SceneEncoding,
    initial_style: torch.Tensor,
    carries: Sequence,
    one_hots: Sequence[torch.Tensor],
    variations: Sequence[torch.Tensor],
    use_initial_style: bool = True,
) -> Tuple[SceneEncoding, List]:
    """One dynamics step per dynamic object over a (B, 1, ...) encoding.

    :param playable_model: render.playable_model.PlayableEnvironmentModel.
    :param carries: per-dynamic-object LSTM carries; None entries start from
        the learnable initial state.
    :return: (new_encoding, new_carries).
    """
    object_ids = ObjectIds(playable_model.scene)
    static = object_ids.static_objects_count
    if len(one_hots) != object_ids.dynamic_objects_count:
        raise ValueError(
            f"interactive_step needs one action per dynamic object "
            f"({object_ids.dynamic_objects_count}), got {len(one_hots)}"
        )
    new_rot = encoding.object_rotations.clone()
    new_trans = encoding.object_translations.clone()
    new_style = encoding.object_style.clone()
    new_deform = encoding.object_deformation.clone()

    new_carries: List = list(carries)
    for dynamic_idx, (one_hot, variation) in enumerate(zip(one_hots, variations)):
        object_idx = static + dynamic_idx
        carry, (rot, trans, style, deform) = playable_model.dynamics_step(
            dynamic_idx,
            carries[dynamic_idx],
            encoding.object_rotations[:, 0, object_idx],
            encoding.object_translations[:, 0, object_idx],
            encoding.object_style[:, 0, object_idx],
            encoding.object_deformation[:, 0, object_idx],
            one_hot,
            variation,
        )
        new_carries[dynamic_idx] = carry
        new_rot[:, 0, object_idx] = rot
        new_trans[:, 0, object_idx] = trans
        new_style[:, 0, object_idx] = style
        new_deform[:, 0, object_idx] = deform

    return encoding.replace(
        object_rotations=new_rot,
        object_translations=new_trans,
        object_style=initial_style if use_initial_style else new_style,
        object_deformation=new_deform,
    ), new_carries
