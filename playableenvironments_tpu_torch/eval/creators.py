"""Reconstructed-dataset creation: render the test split through the model
into a mirrored on-disk dataset for offline metric computation.

Port of playableenvironments_tpu/eval/creators.py's full-frame path:
`FrameRenderer` (scene encoding in eval mode, then render.fast's frame
render with the decoder, or with `use_fast=False` the composer-based frame
path, which also takes `use_fine` models) and the plain
`ReconstructedDatasetCreator`. The camera-manipulation and playability
creators are not ported yet.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.data.video import Video, _save_image
from playableenvironments_tpu_torch.render import sampling
from playableenvironments_tpu_torch.render.fast import render_frame_fast
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding


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
            frames = self.renderer.render(encoding).cpu().numpy()
            for element_idx in range(frames.shape[0]):
                video_idx = int(batch.video_indexes[element_idx])
                frame_idx = int(batch.video_frame_indexes[element_idx, 0])
                for camera_pos, camera_idx in enumerate(dataset.allowed_cameras):
                    camera_dir = os.path.join(output_root, f"{video_idx:05}", f"{camera_idx:05}")
                    os.makedirs(camera_dir, exist_ok=True)
                    _save_frame(
                        frames[element_idx, 0, camera_pos],
                        os.path.join(camera_dir, f"{frame_idx:05}.png"),
                    )
        for video_idx, video in enumerate(dataset.videos):
            for camera_idx in dataset.allowed_cameras:
                src = video.videos[camera_idx].path
                dst = os.path.join(output_root, f"{video_idx:05}", f"{camera_idx:05}")
                if src and os.path.isdir(dst):
                    _copy_metadata(src, dst)
        return output_root
