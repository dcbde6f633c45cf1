"""Reconstructed-dataset creation: render the test split through the model
into a mirrored on-disk dataset for offline metric computation.

Port of playableenvironments_tpu/eval/creators.py's full-frame path:
`FrameRenderer` (scene encoding in eval mode, then render.fast's frame
render with the decoder) and the plain `ReconstructedDatasetCreator`. The
camera-manipulation and playability creators are not ported yet.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.data.video import Video, _save_image
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

    def __init__(self, model, autoencoder, image_size, patch_strides: Optional[Sequence[int]] = None):
        """:param model: render.environment_model.EnvironmentModel (the
        composer and object encoders). :param autoencoder:
        models.autoencoder.MultiresAutoencoder or None. :param image_size:
        (height, width) of the rendered frames."""
        self.model = model
        self.autoencoder = autoencoder
        self.image_size = tuple(image_size)
        self.patch_strides = list(patch_strides) if patch_strides else None
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
        return render_frame_fast(
            self.model.scene, self.model.composer, self.autoencoder, encoding, self.image_size,
            patch_strides=self.patch_strides, focal_length_multiplier=self.model.focal_length_multiplier,
        )


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
