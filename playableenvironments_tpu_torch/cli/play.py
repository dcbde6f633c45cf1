"""Interactive playable-environment session.

Port of playableenvironments_tpu/cli/play.py::InteractiveSession: scene
state and dynamics carries held between user actions, one dynamics step per
dynamic object and a full re-render per step. The session starts from a
dataset batch (`initialize`: frame 0 encoded in eval mode through
eval.creators.FrameRenderer, as the JAX session does) or from a
SceneEncoding (`start`). The CLI's `main()` needs checkpoint restore and is
not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from playableenvironments_tpu_torch.config import ObjectIds, SceneConfig
from playableenvironments_tpu_torch.render.fast import render_frame_fast
from playableenvironments_tpu_torch.render.interactive import action_inputs, interactive_step
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding


class InteractiveSession:
    """Holds scene state + dynamics carries between user actions."""

    def __init__(
        self,
        scene: SceneConfig,
        composer,
        autoencoder,
        playable_model,
        image_size: Tuple[int, int],
        patch_strides: Optional[Sequence[int]] = None,
        focal_length_multiplier: float = 1.0,
        environment_model=None,
    ):
        """:param composer: render.composer.SceneComposer; :param autoencoder:
        models.autoencoder.MultiresAutoencoder or None; :param playable_model:
        render.playable_model.PlayableEnvironmentModel; :param
        environment_model: render.environment_model.EnvironmentModel holding
        `composer`, needed by `initialize` only. All on one device, which is
        where the session runs."""
        self.scene = scene
        self.composer = composer
        self.autoencoder = autoencoder
        self.playable_model = playable_model
        self.image_size = tuple(image_size)
        self.patch_strides = list(patch_strides) if patch_strides else None
        self.focal_length_multiplier = focal_length_multiplier
        self.device = next(composer.parameters()).device
        self.object_ids = ObjectIds(scene)
        self.encoding: Optional[SceneEncoding] = None
        self.carries: List = []
        self.initial_style: Optional[torch.Tensor] = None
        self.renderer = None
        if environment_model is not None:
            from playableenvironments_tpu_torch.eval.creators import FrameRenderer

            if environment_model.composer is not composer:
                raise ValueError("the environment model must hold the session's composer")
            self.renderer = FrameRenderer(environment_model, autoencoder, image_size, patch_strides)

    @classmethod
    def from_scene(
        cls,
        scene: SceneConfig,
        image_size: Tuple[int, int],
        patch_strides: Optional[Sequence[int]] = None,
        focal_length_multiplier: float = 1.0,
        device="cuda",
        seed: int = 0,
    ) -> "InteractiveSession":
        """A session over seeded random weights for `scene` on `device`
        (compat.from_flax loads trained ones into its modules). The
        environment model's composer is seeded as a SceneComposer of its
        own would be, its object encoders and its autoencoder (the
        session's decoder) from `seed` + 1."""
        from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
        from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel

        model = EnvironmentModel(scene, focal_length_multiplier, device=device, seed=seed)
        autoencoder = getattr(model, "autoencoder", None)
        playable = PlayableEnvironmentModel(scene, device=device, seed=seed + 2)
        return cls(
            scene, model.composer, autoencoder, playable, image_size, patch_strides,
            focal_length_multiplier, environment_model=model,
        )

    def render(self, encoding: SceneEncoding) -> torch.Tensor:
        """(B, T, C, H, W, 3) frames of `encoding` on the session's device."""
        return render_frame_fast(
            self.scene, self.composer, self.autoencoder, encoding, self.image_size,
            patch_strides=self.patch_strides,
            focal_length_multiplier=self.focal_length_multiplier,
        )

    def initialize(self, batch) -> np.ndarray:
        """Encode a data.batching.Batch in eval mode, take frame 0 of its
        first observation as the state and render it.
        :return: (H, W, 3) float32 frame."""
        if self.renderer is None:
            raise ValueError("initialize(batch) needs the session's environment_model")
        return self.start(self.renderer.encode(batch))

    def start(self, encoding: SceneEncoding) -> np.ndarray:
        """Take frame 0 of `encoding` as the state and render it.
        :return: (H, W, 3) float32 frame."""
        self.encoding = encoding.map(lambda x: x[:, :1].to(self.device))
        self.initial_style = self.encoding.object_style
        self.carries = [None] * self.object_ids.dynamic_objects_count
        return self.render(self.encoding)[0, 0, 0].cpu().numpy()

    def step(self, actions: List[int]) -> np.ndarray:
        """One dynamics step per dynamic object, then a full re-render.

        :param actions: one action index per dynamic object.
        :return: (H, W, 3) float32 frame.
        """
        one_hots, variations = action_inputs(self.playable_model, actions, device=self.device)
        self.encoding, self.carries = interactive_step(
            self.playable_model, self.encoding, self.initial_style, self.carries,
            one_hots, variations,
        )
        return self.render(self.encoding)[0, 0, 0].cpu().numpy()
