"""Phase-3 training-time evaluator.

Port of playableenvironments_tpu/eval/playable_evaluator.py, three products:
(1) validation losses on a held-out split, (2) one generated video a
action, every dynamic object driven by that action (clamped to its own
count) from the frame-0 state through `rollout_single` (one fused rollout
launch an object: B4 on the card, forward only), (3) a ground-truth
sequence re-enacted from one frame with the inferred actions under the
zero-variation modifier, in eval mode. Videos and gifs land under
`<results>/playable_eval/step_<N>/` (the mp4 is skipped where cv2 or its
codec is missing), the losses go through the Logger with a `val_` prefix.
The evaluator reads the trainer's live state: its playable model, its
centroids and its frozen environment model.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from playableenvironments_tpu_torch.config import ObjectIds
from playableenvironments_tpu_torch.eval.action_modifiers import zero_variation_action_modifier
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.utils.random import RngStreams, step_streams


def _broadcast_frame0(encoding: SceneEncoding, frames: int) -> SceneEncoding:
    """The frame-0 state repeated along a time axis of `frames`."""
    return encoding.map(lambda x: x[:, :1].repeat((1, frames) + (1,) * (x.dim() - 2)))


class PlayableModelEvaluator:
    """Periodic qualitative and quantitative phase-3 evaluation."""

    def __init__(self, trainer, dataset, results_dir: str, batch_size: int = 2, val_batches: int = 2,
                 action_video_frames: int = 8, framerate: int = 5, patch_strides: Optional[Sequence[int]] = None,
                 seed: int = 0):
        """:param trainer: train.trainer_playable.PlayableTrainer with its
        frozen environment model. :param dataset: the validation
        MulticameraVideoDataset (phase-3 windows)."""
        self.trainer = trainer
        self.dataset = dataset
        self.results_dir = results_dir
        self.batch_size = batch_size
        self.val_batches = val_batches
        self.action_video_frames = action_video_frames
        self.framerate = framerate
        self.patch_strides = list(patch_strides) if patch_strides else None
        self.seed = seed
        self.object_ids = ObjectIds(trainer.playable_model.scene)
        self.device = next(trainer.playable_model.parameters()).device

    def _renderer(self, image_size):
        from playableenvironments_tpu_torch.eval.creators import FrameRenderer

        env = self.trainer.environment_model
        return FrameRenderer(env, getattr(env, "autoencoder", None), image_size, patch_strides=self.patch_strides)

    @torch.no_grad()
    def validation_losses(self) -> Dict[str, float]:
        """The generator's losses over the first `val_batches` batches, in
        train mode on batch statistics that update nothing (centroids and MI
        matrices untouched), each batch drawing from step_streams(seed + 7,
        batch index). :return: their means, `val_`-prefixed."""
        sums: Dict[str, float] = {}
        count = 0
        for batch_idx, batch in enumerate(self.dataset.iterate_batches(self.batch_size, shuffle=False,
                                                                       drop_last=False)):
            if batch_idx >= self.val_batches:
                break
            encoding = self.trainer.encode_batch(batch)
            _, metrics, _, _ = self.trainer.compute_losses(
                encoding, step_streams(self.seed + 7, batch_idx, device=self.device), self.trainer.step,
                update_stats=False)
            for name, value in metrics.items():
                sums[name] = sums.get(name, 0.0) + float(value)
            count += 1
        return {f"val_{k}": v / max(count, 1) for k, v in sums.items()}

    def action_video_encoding(self, encoding: SceneEncoding, action_idx: int) -> SceneEncoding:
        """The frame-0 state of a (1, T, ...) encoding rolled forward
        `action_video_frames` - 1 steps with `action_idx` for every dynamic
        object (clamped to the object's action count), one rollout_single an
        object."""
        playable = self.trainer.playable_model
        frames = self.action_video_frames
        rollout = _broadcast_frame0(encoding, frames)
        leaves = [rollout.object_rotations, rollout.object_translations, rollout.object_style,
                  rollout.object_deformation]
        for dynamic_idx in range(self.object_ids.dynamic_objects_count):
            obj = self.object_ids.object_idx_by_dynamic_object_idx(dynamic_idx)
            anim_cfg = playable.scene.animation_models[playable.animation_indexes[dynamic_idx]]
            index = torch.full((1, frames - 1), min(action_idx, anim_cfg.actions_count - 1), dtype=torch.long,
                               device=self.device)
            one_hot = F.one_hot(index, anim_cfg.actions_count).to(torch.float32)
            variation = torch.zeros((1, frames - 1, anim_cfg.action_space_dimension), device=self.device)
            rec = playable.rollout_single(dynamic_idx, *(leaf[:, :, obj].contiguous() for leaf in leaves),
                                          one_hot, variation)
            for leaf, value in zip(leaves, rec):
                leaf[:, :, obj] = value
        return rollout.replace(object_rotations=leaves[0], object_translations=leaves[1], object_style=leaves[2],
                               object_deformation=leaves[3])

    def generate_action_video(self, encoding: SceneEncoding, action_idx: int, renderer) -> np.ndarray:
        """:return: (frames, H, W, 3) rendered rollout of action_video_encoding."""
        return renderer.render(self.action_video_encoding(encoding, action_idx))[0, :, 0].cpu().numpy()

    @torch.no_grad()
    def reenacted_encoding(self, encoding: SceneEncoding) -> SceneEncoding:
        """One ground-truth frame, then the actions inferred from the
        sequence with zero variations, in eval mode (running statistics, no
        centroid update), each object's reconstruction put back."""
        playable = self.trainer.playable_model
        results = playable.animate(
            encoding, 1, self.trainer._per_object_centroids(self.trainer.centroids), RngStreams(self.seed, self.device),
            update_stats=False, action_modifier=zero_variation_action_modifier, use_running_average=True,
        )
        leaves = [encoding.object_rotations.clone(), encoding.object_translations.clone(),
                  encoding.object_style.clone(), encoding.object_deformation.clone()]
        keys = ("rotations", "translations", "style", "deformation")
        for dynamic_idx, res in enumerate(results):
            obj = self.object_ids.object_idx_by_dynamic_object_idx(dynamic_idx)
            for leaf, key in zip(leaves, keys):
                leaf[..., obj, :] = res[f"reconstructed_object_{key}"]
        return encoding.replace(object_rotations=leaves[0], object_translations=leaves[1], object_style=leaves[2],
                                object_deformation=leaves[3])

    def evaluate(self, logger, step: int) -> Dict[str, float]:
        """Run the three products. :return: the validation losses."""
        from playableenvironments_tpu_torch.utils.video_io import save_gif, save_video

        losses = self.validation_losses()
        logger.log(losses, step)
        out_dir = os.path.join(self.results_dir, "playable_eval", f"step_{step}")
        os.makedirs(out_dir, exist_ok=True)

        batch = next(self.dataset.iterate_batches(1, shuffle=False, drop_last=False))
        renderer = self._renderer(tuple(batch.observations.shape[-3:-1]))
        encoding = self.trainer.encode_batch(batch)
        actions_count = max(cfg.actions_count for cfg in self.trainer.scene_animation_configs())
        for action_idx in range(actions_count):
            frames = self.generate_action_video(encoding, action_idx, renderer)
            base = os.path.join(out_dir, f"action_{action_idx}")
            try:
                save_video(list(frames), base + ".mp4", framerate=self.framerate)
            except (OSError, RuntimeError):
                pass  # no cv2 or no codec: the gif still lands
            save_gif(list(frames), base + ".gif", framerate=self.framerate)

        reconstruction = renderer.render(self.reenacted_encoding(encoding))[0, :, 0].cpu().numpy()
        ground_truth = batch.observations[0, :, 0].float().numpy()
        strip = np.concatenate([np.concatenate(list(ground_truth), axis=1),
                                np.concatenate(list(reconstruction), axis=1)], axis=0)
        logger.log_image("playable_reenactment", strip, step)
        save_gif(list(reconstruction), os.path.join(out_dir, "reenactment.gif"), framerate=self.framerate)
        return losses


def build_playable_evaluator(cfg: Dict, trainer, train_dataset, results_dir: str,
                             seed: int = 0) -> PlayableModelEvaluator:
    """The evaluator of an experiment YAML: the `val` split windowed by the
    phase-3 batching (as overrides of `training.batching`), the training
    dataset where there is no `val` split, and the autoencoder's patch
    strides where the model decodes."""
    from playableenvironments_tpu_torch.cli.common import build_dataset, with_batching_overrides

    t = cfg.get("playable_model_training", {})
    try:
        dataset = build_dataset(with_batching_overrides(cfg, **t.get("batching", {})), "val")
    except FileNotFoundError:
        dataset = train_dataset
    patch_strides = None
    scene = trainer.playable_model.scene
    if scene.autoencoder is not None:
        from playableenvironments_tpu_torch.models.autoencoder import autoencoder_strides

        patch_strides = autoencoder_strides(scene.autoencoder)
    return PlayableModelEvaluator(
        trainer, dataset, results_dir,
        batch_size=int(t.get("eval_batch_size", 2)),
        val_batches=int(t.get("eval_batches", 2)),
        action_video_frames=int(t.get("eval_action_video_frames", 8)),
        patch_strides=patch_strides,
        seed=seed,
    )
