"""Interactive playable-environment session and the play CLI.

Port of playableenvironments_tpu/cli/play.py. `InteractiveSession`: scene
state and dynamics carries held between user actions, one dynamics step per
dynamic object and a full re-render per step. The session starts from a
dataset batch (`initialize`: frame 0 encoded in eval mode through
eval.creators.FrameRenderer, as the JAX session does) or from a
SceneEncoding (`start`).

    python -m playableenvironments_tpu_torch.cli.play --config <yaml> \
        --environment_checkpoint <phase-2 checkpoint> --playable_checkpoint <phase-3 checkpoint> \
        [--script 0,0,1,2] [--output out_dir] [--device cuda|cpu]

`main()` restores both checkpoints, starts from the first batch of the
`test` split (evaluation batching as overrides of the training one, one
observation), and plays the comma-separated `--script` headless (every
dynamic object takes each action), or without one reads keys in a cv2
window (digits choose the action, q quits). It writes the frames as PNGs,
an mp4 (skipped with a message where cv2 or its codec is missing) and a
gif under `--output`, with the run's timing, and returns the frames. Runs
on the card by default; without one it raises unless `--device cpu`.
`evaluation.mesh: {data, rays}` splits each frame's rays over the
process's cards (cli.common.build_eval_mesh).
"""

from __future__ import annotations

import argparse
import os
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
        mesh=None,
    ):
        """:param composer: render.composer.SceneComposer; :param autoencoder:
        models.autoencoder.MultiresAutoencoder or None; :param playable_model:
        render.playable_model.PlayableEnvironmentModel; :param
        environment_model: render.environment_model.EnvironmentModel holding
        `composer`, needed by `initialize` only. All on one device, which is
        where the session runs. :param mesh: a parallel.mesh.DeviceMesh over
        which each frame's rays split (cli.common.build_eval_mesh)."""
        self.scene = scene
        self.composer = composer
        self.autoencoder = autoencoder
        self.playable_model = playable_model
        self.image_size = tuple(image_size)
        self.patch_strides = list(patch_strides) if patch_strides else None
        self.focal_length_multiplier = focal_length_multiplier
        self.mesh = mesh
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
            self.renderer = FrameRenderer(environment_model, autoencoder, image_size, patch_strides, mesh=mesh)

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
            focal_length_multiplier=self.focal_length_multiplier, mesh=self.mesh,
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


def main() -> List[np.ndarray]:
    parser = argparse.ArgumentParser(description="Interactive play")
    parser.add_argument("--config", required=True)
    parser.add_argument("--environment_checkpoint", required=True)
    parser.add_argument("--playable_checkpoint", required=True)
    parser.add_argument("--script", default=None, help="comma-separated action list for headless play")
    parser.add_argument("--output", default="play_output")
    parser.add_argument("--framerate", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.common import (
        RunTimes, build_dataset, build_environment_model, build_eval_mesh, load_yaml, with_batching_overrides,
    )
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train import checkpointing
    from playableenvironments_tpu_torch.train.trainer_playable import PlayableTrainer, PlayableTrainingConfig
    from playableenvironments_tpu_torch.utils.device import resolve_device
    from playableenvironments_tpu_torch.utils.video_io import save_frames, save_gif, save_video

    times = RunTimes()
    device = resolve_device(args.device)
    cfg = load_yaml(args.config)
    mesh = build_eval_mesh(cfg, device)
    env_model = build_environment_model(cfg, device=device, seed=args.seed)
    checkpointing.restore_params(args.environment_checkpoint, env_model)
    playable = PlayableEnvironmentModel(
        env_model.scene, with_discriminators=checkpointing.has_discriminators(args.playable_checkpoint),
        device=device, seed=args.seed)
    # The whole phase-3 state, as the JAX CLI restores it (the centroids are
    # the trainer's).
    checkpointing.restore_checkpoint(args.playable_checkpoint,
                                     PlayableTrainer(playable, PlayableTrainingConfig(), environment_model=env_model))

    # Evaluation batching as overrides of training.batching, so that keys it
    # omits (allowed_cameras, observation_stacking) keep the training values.
    eval_batching = cfg.get("evaluation", {}).get("batching", {})
    dataset = build_dataset(with_batching_overrides(cfg, **{**eval_batching, "observations_count": 1}), "test")
    batch = next(dataset.iterate_batches(1, shuffle=False))
    strides = None
    if env_model.scene.autoencoder is not None:
        from playableenvironments_tpu_torch.models.autoencoder import autoencoder_strides

        strides = autoencoder_strides(env_model.scene.autoencoder)
    session = InteractiveSession(
        env_model.scene, env_model.composer, getattr(env_model, "autoencoder", None), playable.eval(),
        dataset.videos[0].image_size(), strides, env_model.focal_length_multiplier, environment_model=env_model,
        mesh=mesh,
    )
    times.startup_done()

    actions_taken: List[int] = []
    with times.section("steps"):
        frames = [session.initialize(batch)]
        if args.script:
            for token in args.script.split(","):
                action = int(token)
                frames.append(session.step([action] * session.object_ids.dynamic_objects_count))
                actions_taken.append(action)
    if not args.script:
        import cv2

        print("keys: 0-9 action, q quit")
        while True:
            cv2.imshow("playable environment", cv2.cvtColor((frames[-1] * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
            key = cv2.waitKey(0) & 0xFF
            if key == ord("q"):
                break
            if ord("0") <= key <= ord("9"):
                action = key - ord("0")
                frames.append(session.step([action] * session.object_ids.dynamic_objects_count))
                actions_taken.append(action)
        cv2.destroyAllWindows()

    with times.section("saves"):
        os.makedirs(args.output, exist_ok=True)
        save_frames(frames, os.path.join(args.output, "frames"))
        try:
            save_video(frames, os.path.join(args.output, "sequence.mp4"), args.framerate,
                       actions=[None] + actions_taken)
        except RuntimeError as error:  # no cv2 or no codec: frames and gif still land
            print(f"mp4 export skipped: {error}")
        save_gif(frames, os.path.join(args.output, "sequence.gif"), args.framerate)
    times.write(args.output, "play")
    print(f"saved {len(frames)} frames to {args.output}")
    return frames


if __name__ == "__main__":
    main()
