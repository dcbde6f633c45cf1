"""Detector-based bounding-box annotation for acquired frame trees.

Port of playableenvironments_tpu/acquisition/boxes.py. Replaces
dataset/acquisition/tennis/compute_bounding_boxes_3.py +
player_detector/tennis_player_detector.py (pretrained FasterRCNN): runs the
in-framework CenterNet detector (cli.train_detector checkpoints) over every
frame of every video and writes per-frame normalized ltrb boxes + validity
into the video's pickled annotations. The detector runs on its trainer's
device (the card by default, train/trainer_detector.py); the annotation is
host NumPy, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from playableenvironments_tpu_torch.data.video import Video

# frame (H, W, 3) float [0,1] -> (boxes (N, 4) normalized ltrb, scores (N,))
BoxDetectorFn = Callable[[np.ndarray], tuple]


def detector_boxes_fn(trainer, top_k: int = 4, threshold: float = 0.3) -> BoxDetectorFn:
    """Adapt a trained detector (train/trainer_detector.py::DetectorTrainer)
    into a BoxDetectorFn: the eval-mode detector's top-k peaks
    (`DetectorTrainer.detect`, models/detector.py::decode_detections) whose
    score is at least `threshold`, their boxes and scores."""

    def fn(frame: np.ndarray):
        out = trainer.detect(torch.from_numpy(np.asarray(frame, np.float32))[None], top_k)
        scores = out["scores"][0].cpu().numpy()
        boxes = out["boxes"][0].cpu().numpy()
        keep = scores >= threshold
        return boxes[keep], scores[keep]

    return fn


def annotate_video_boxes(
    camera_dir: str,
    detector: BoxDetectorFn,
    objects_count: int,
) -> int:
    """Detect players in every frame of one camera directory and rewrite its
    bounding-box annotations. Detections are padded/truncated to
    `objects_count` boxes per frame (static shape for the dataset contract);
    missing detections get validity False.

    :return: number of frames annotated.
    """
    video = Video().load(camera_dir)
    boxes_per_frame, validity_per_frame = [], []
    for idx in range(video.frames_count):
        frame = video.get_frame(idx)
        boxes, scores = detector(frame)
        order = np.argsort(-scores)[:objects_count]
        chosen = boxes[order]
        valid = np.zeros(objects_count, bool)
        padded = np.tile(
            np.asarray([0.25, 0.25, 0.75, 0.75], np.float32),
            (objects_count, 1),
        )
        padded[: len(chosen)] = chosen
        valid[: len(chosen)] = True
        boxes_per_frame.append(padded.T)  # disk layout (4, objects)
        validity_per_frame.append(valid)
    video.bounding_boxes = [np.asarray(b, np.float32) for b in boxes_per_frame]
    video.bounding_boxes_validity = validity_per_frame
    video.save_annotations(camera_dir)
    return video.frames_count


def annotate_dataset_boxes(
    root: str, detector: BoxDetectorFn, objects_count: int
) -> int:
    """Annotate every <video>/<camera> directory under `root`."""
    total = 0
    for video_name in sorted(os.listdir(root)):
        video_dir = os.path.join(root, video_name)
        if not os.path.isdir(video_dir):
            continue
        for camera_name in sorted(os.listdir(video_dir)):
            camera_dir = os.path.join(video_dir, camera_name)
            if os.path.isdir(camera_dir):
                total += annotate_video_boxes(camera_dir, detector, objects_count)
    return total
