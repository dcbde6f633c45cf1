"""Reconstructed-dataset creation: render the test split through the model
into a mirrored on-disk dataset for offline metric computation.

Port of playableenvironments_tpu/eval/creators.py's full-frame path:
`FrameRenderer` (scene encoding in eval mode, then render.fast's frame
render with the decoder, or with `use_fast=False` the composer-based frame
path, which also takes `use_fine` models), the plain
`ReconstructedDatasetCreator`, `ReconstructedCameraManipulationDatasetCreator`
(novel views: the frame-0 scene replayed along the ground-truth camera
trajectory) and `ReconstructedPlayabilityDatasetCreator` (re-enactment: one
ground-truth frame, then the dynamics driven by the inferred actions with
zero variations, in eval mode; the rollout is one fused rollout launch an
object, B4 on the card, forward only). Every frame goes through
FrameRenderer (B1 on the card). The mirrors keep the reference tree's
layout and file names, with its annotations copied.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from playableenvironments_tpu_torch.config import ObjectIds
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.data.video import Video, _save_image
from playableenvironments_tpu_torch.render import sampling
from playableenvironments_tpu_torch.render.fast import render_frame_fast
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.utils.random import RngStreams


def _save_frame(array: np.ndarray, path: str):
    """PNG write through the native C++ encoder, Pillow where it does not
    load; the creators write one file per rendered frame."""
    _save_image(np.asarray(array), path)


def _copy_metadata(src_camera_dir: str, dst_camera_dir: str):
    """Copy the pickled annotation files alongside rendered frames."""
    for filename in list(Video.PICKLE_FILES.values()) + list(Video.OPTIONAL_PICKLE_FILES.values()):
        src = os.path.join(src_camera_dir, filename)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(dst_camera_dir, filename))


class FrameRenderer:
    """The creators' full-frame path: scene encoding -> strided-grid render
    -> decoder, on the device the environment model lies on."""

    def __init__(self, model, autoencoder, image_size, patch_strides: Optional[Sequence[int]] = None,
                 ray_tile: int = 0, use_fast: bool = True):
        """:param model: render.environment_model.EnvironmentModel (the
        composer and object encoders). :param autoencoder:
        models.autoencoder.MultiresAutoencoder or None. :param image_size:
        (height, width) of the rendered frames.
        :param use_fast: render.fast's frame render (the B1 kernel); False
            takes EnvironmentModel.render_frame_from_scene_encoding in tiles
            of `ray_tile` rays and decode_rendered_grids, which decode with
            the model's own autoencoder. As the JAX renderer, that path
            returns the coarse pass's frames even when the scene has a fine
            one."""
        self.model = model
        self.autoencoder = autoencoder
        self.image_size = tuple(image_size)
        self.patch_strides = list(patch_strides) if patch_strides else None
        self.ray_tile = ray_tile
        self.use_fast = use_fast
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def encode(self, batch) -> SceneEncoding:
        """The eval-mode scene encoding of a data.batching.Batch (running
        statistics read, none updated, no style shuffle, no draw) on the
        renderer's device."""
        encoding, _ = self.model.compute_scene_encoding(
            *batch.to(self.device).environment_model_args(), shuffle_style=False, train=False,
        )
        return encoding

    def render(self, encoding: SceneEncoding) -> torch.Tensor:
        """:return: (B, T, C, H, W, 3) frames in [0, 1]."""
        if self.use_fast:
            return render_frame_fast(
                self.model.scene, self.model.composer, self.autoencoder, encoding, self.image_size,
                patch_strides=self.patch_strides, focal_length_multiplier=self.model.focal_length_multiplier,
            )
        return self._render_composed(encoding)

    @torch.no_grad()
    def _render_composed(self, encoding: SceneEncoding) -> torch.Tensor:
        out = self.model.render_frame_from_scene_encoding(encoding, self.image_size, self.patch_strides,
                                                          self.ray_tile, train=False)
        height, width = self.image_size
        if self.autoencoder is not None and self.patch_strides:
            out = self.model.decode_rendered_grids(out, self.image_size, train=False)
            frames = out["coarse"]["global"]["reconstructed_observations"]
        else:
            features = out["coarse"]["global"]["integrated_features"]
            if self.patch_strides:
                features = sampling.split_strided_grid_samples(features, self.patch_strides, self.image_size)[0]
                lead = features.shape[:-3]
                flat = features.reshape((-1,) + features.shape[-3:]).permute(0, 3, 1, 2)
                # jax.image.resize "bilinear" upsampling: half-pixel centres.
                flat = torch.nn.functional.interpolate(flat, size=(height, width), mode="bilinear",
                                                       align_corners=False, antialias=False)
                frames = flat.permute(0, 2, 3, 1).reshape(lead + (height, width, flat.shape[1]))
            else:
                frames = features.reshape(features.shape[:-2] + (height, width, features.shape[-1]))
        return torch.clamp(frames, 0.0, 1.0)


def _save_window(frames: np.ndarray, batch, dataset: MulticameraVideoDataset, output_root: str):
    """Write (B, T, C, H, W, 3) frames under `<root>/<video>/<camera>/<frame>.png`,
    each at the dataset frame index it renders."""
    for element_idx in range(frames.shape[0]):
        video_idx = int(batch.video_indexes[element_idx])
        for t in range(frames.shape[1]):
            frame_idx = int(batch.video_frame_indexes[element_idx, t])
            for camera_pos, camera_idx in enumerate(dataset.allowed_cameras):
                camera_dir = os.path.join(output_root, f"{video_idx:05}", f"{camera_idx:05}")
                os.makedirs(camera_dir, exist_ok=True)
                _save_frame(frames[element_idx, t, camera_pos], os.path.join(camera_dir, f"{frame_idx:05}.png"))


def _copy_dataset_metadata(dataset: MulticameraVideoDataset, output_root: str) -> List[tuple]:
    """Copy every written camera's annotations, so that the mirror loads as
    a dataset. :return: (video index, mirror camera directory) of each."""
    copied = []
    for video_idx, video in enumerate(dataset.videos):
        for camera_idx in dataset.allowed_cameras:
            src = video.videos[camera_idx].path
            dst = os.path.join(output_root, f"{video_idx:05}", f"{camera_idx:05}")
            if src and os.path.isdir(dst):
                _copy_metadata(src, dst)
                copied.append((video_idx, dst))
    return copied


def _non_overlapping(dataset: MulticameraVideoDataset, observations_count: int):
    """Windows of `observations_count` that do not overlap: with every
    offset, a later window would re-render (and overwrite) the frames of
    earlier ones with its own frame-0 reconstruction."""
    dataset.set_observations_count(
        observations_count, window_stride=(dataset.skip_frames + 1) * (observations_count - 1) + 1)


class ReconstructedDatasetCreator:
    """Render every frame of every video into a mirror dataset: the same
    tree and file names, the annotations copied, so that the mirror loads as
    a dataset."""

    def __init__(self, renderer: FrameRenderer, batch_size: int = 4):
        self.renderer = renderer
        self.batch_size = batch_size

    def reconstruct_dataset(self, dataset: MulticameraVideoDataset, output_root: str) -> str:
        os.makedirs(output_root, exist_ok=True)
        dataset.set_observations_count(1)
        for batch in dataset.iterate_batches(self.batch_size, shuffle=False, drop_last=False):
            encoding = self.renderer.encode(batch)
            _save_window(self.renderer.render(encoding).cpu().numpy(), batch, dataset, output_root)
        _copy_dataset_metadata(dataset, output_root)
        return output_root


def frozen_encoding(encoding: SceneEncoding) -> SceneEncoding:
    """Every object's frame-0 state broadcast along the trajectory; the
    cameras keep each frame's ground truth."""
    first = lambda x: x[:, :1].expand(x.shape).contiguous()  # noqa: E731
    return encoding.replace(
        object_rotations=first(encoding.object_rotations), object_translations=first(encoding.object_translations),
        object_style=first(encoding.object_style), object_deformation=first(encoding.object_deformation),
        object_in_scene=first(encoding.object_in_scene))


class ReconstructedCameraManipulationDatasetCreator:
    """Freeze the frame-0 scene state and replay the ground-truth camera
    trajectory (novel-view evaluation), over non-overlapping windows of
    `observations_count` frames, one window a batch."""

    def __init__(self, renderer: FrameRenderer):
        self.renderer = renderer

    def reconstruct_dataset(self, dataset: MulticameraVideoDataset, output_root: str,
                            observations_count: int) -> str:
        os.makedirs(output_root, exist_ok=True)
        _non_overlapping(dataset, observations_count)
        for batch in dataset.iterate_batches(1, shuffle=False, drop_last=False):
            encoding = self.renderer.encode(batch)
            _save_window(self.renderer.render(frozen_encoding(encoding)).cpu().numpy(), batch, dataset, output_root)
        _copy_dataset_metadata(dataset, output_root)
        return output_root


class ReconstructedPlayabilityDatasetCreator:
    """Re-enact each window from one ground-truth frame with the actions
    inferred from it (zero variations, eval mode: running statistics read,
    none updated, centroids untouched) and render the rollouts; the first
    dynamic object's inferred action of each frame but a window's last is
    written into the mirror's metadata.pkl as `inferred_action`. One window
    a batch.

    The action network's posterior and gumbel draws come from
    RngStreams(0) on the host, anew for each window, as the JAX creator
    applies fixed keys to each batch (its draws are not the port's). They
    are few, and drawn on the host they are the same numbers on the card
    and on the CPU, so that the two re-enact alike."""

    def __init__(self, renderer: FrameRenderer, playable_model, centroids: Sequence[torch.Tensor]):
        """:param playable_model: render.playable_model.PlayableEnvironmentModel
        on the renderer's device. :param centroids: per dynamic object its
        (A, S) action centroids (PlayableTrainer._per_object_centroids)."""
        from playableenvironments_tpu_torch.eval.action_modifiers import zero_variation_action_modifier

        self.renderer = renderer
        self.playable_model = playable_model
        self.centroids = list(centroids)
        self.action_modifier = zero_variation_action_modifier

    @torch.no_grad()
    def reenact(self, encoding: SceneEncoding):
        """:return: (the encoding with each dynamic object's reconstructed
        states in its slots, animate's per-object results)."""
        results = self.playable_model.animate(
            encoding, 1, self.centroids, RngStreams(0, "cpu"), update_stats=False,
            action_modifier=self.action_modifier, use_running_average=True)
        leaves = {key: getattr(encoding, f"object_{key}").clone()
                  for key in ("rotations", "translations", "style", "deformation")}
        static = ObjectIds(self.playable_model.scene).static_objects_count
        for dynamic_idx, res in enumerate(results):
            for key, leaf in leaves.items():
                leaf[..., static + dynamic_idx, :] = res[f"reconstructed_object_{key}"]
        return encoding.replace(**{f"object_{key}": leaf for key, leaf in leaves.items()}), results

    def reconstruct_dataset(self, dataset: MulticameraVideoDataset, output_root: str,
                            observations_count: int) -> str:
        os.makedirs(output_root, exist_ok=True)
        _non_overlapping(dataset, observations_count)
        inferred_actions_by_video: Dict[int, Dict[int, int]] = {}
        for batch in dataset.iterate_batches(1, shuffle=False, drop_last=False):
            reenacted, results = self.reenact(self.renderer.encode(batch))
            frames = self.renderer.render(reenacted).cpu().numpy()
            actions = results[0]["sampled_actions"].argmax(dim=-1).cpu().numpy()  # (B, T - 1)
            for element_idx in range(frames.shape[0]):
                per_frame = inferred_actions_by_video.setdefault(int(batch.video_indexes[element_idx]), {})
                for t in range(frames.shape[1] - 1):
                    per_frame[int(batch.video_frame_indexes[element_idx, t])] = int(actions[element_idx, t])
            _save_window(frames, batch, dataset, output_root)

        for video_idx, dst in _copy_dataset_metadata(dataset, output_root):
            metadata_path = os.path.join(dst, "metadata.pkl")
            if not os.path.isfile(metadata_path):
                continue
            with open(metadata_path, "rb") as f:
                metadata = pickle.load(f)
            for frame_idx, action in inferred_actions_by_video.get(video_idx, {}).items():
                if frame_idx < len(metadata):
                    entry = metadata[frame_idx] if isinstance(metadata[frame_idx], dict) else {}
                    entry["inferred_action"] = action
                    metadata[frame_idx] = entry
            with open(metadata_path, "wb") as f:
                pickle.dump(metadata, f)
        return output_root
