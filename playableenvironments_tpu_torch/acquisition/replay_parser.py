"""Minecraft ReplayMod-recording ingestion.

Copy of playableenvironments_tpu/acquisition/replay_parser.py (the port imports
nothing of the JAX package).

Replaces dataset/acquisition/minecraft/splitted_recording.py +
acquire_replays.py: a recording = a rendered video file, a JSON annotation
stream (per-frame camera + entity poses in Minecraft's coordinate/rotation
conventions), and a text split file (world center + [start, end] second
ranges). Each split becomes one single-camera Video in the on-disk dataset
format.

Conventions converted here (splitted_recording.py:294-335):
- Minecraft rotations are degrees, opposite-handed: dataset radians are
  (360 - rot) * pi/180, wrapped to (-2pi, 2pi) (z additionally to [0, 2pi)).
- Positions are recentered on the split file's world center.
- Focal length from the vertical FOV: f = (H/2) / tan(y_fov/2).
- 2D boxes: the player's 3D box (0.15 half-width/depth, 0.5 height... the
  published scale) projected through the camera; bottom = the feet point.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from playableenvironments_tpu_torch.acquisition import geometry
from playableenvironments_tpu_torch.data.video import PoseParametersNumpy, Video

# The minecraft player's object-frame AABB (x, y, z) spans.
PLAYER_BOX = np.asarray(
    [(-0.15, 0.15), (0.0, 0.5), (-0.15, 0.15)], np.float32
)


def minecraft_rotation_to_dataset(
    rotation_degrees: float, modulo_threesixty: bool = False
) -> float:
    """Degrees (Minecraft handedness) -> radians (dataset handedness)."""
    r = (-rotation_degrees + 360.0) * math.pi / 180.0
    while r <= -2 * math.pi:
        r += 2 * math.pi
    while r >= 2 * math.pi:
        r -= 2 * math.pi
    if modulo_threesixty:
        while r < 0:
            r += 2 * math.pi
        while r >= 2 * math.pi:
            r -= 2 * math.pi
    return r


def focal_from_fov(image_height: int, y_fov: float) -> float:
    return (image_height / 2.0) / math.tan(y_fov / 2.0)


def annotation_to_pose(
    entry: Dict, world_center: Sequence[float]
) -> PoseParametersNumpy:
    rotations = [
        minecraft_rotation_to_dataset(entry["rotX"]),
        minecraft_rotation_to_dataset(entry["rotY"]),
        minecraft_rotation_to_dataset(entry["rotZ"], modulo_threesixty=True),
    ]
    translations = [
        entry["posX"] - world_center[0],
        entry["posY"] - world_center[1],
        entry["posZ"] - world_center[2],
    ]
    return PoseParametersNumpy(rotation=rotations, translation=translations)


def read_split_file(path: str) -> Tuple[List[Tuple[int, int]], List[int]]:
    """First non-comment line: world center 'x y z'; following lines:
    'start_seconds end_seconds' per split."""
    world_center: Optional[List[int]] = None
    splits: List[Tuple[int, int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            values = [int(v) for v in line.split()]
            if world_center is None:
                world_center = values
            else:
                if len(values) != 2:
                    raise ValueError(
                        f"split line must be 'start end', got {line!r}"
                    )
                splits.append((values[0], values[1]))
    if world_center is None:
        raise ValueError(f"{path}: missing world-center line")
    return splits, world_center


class ReplayRecording:
    """One recorded session: annotations JSON + split file (+ video file)."""

    def __init__(
        self,
        annotation_file: str,
        split_file: str,
        video_file: Optional[str] = None,
        framerate: Optional[int] = None,
    ):
        with open(annotation_file) as f:
            self.annotations = json.load(f)
        self.splits, self.world_center = read_split_file(split_file)
        self.video_file = video_file
        self._framerate = framerate

    @property
    def framerate(self) -> int:
        if self._framerate is not None:
            return self._framerate
        if "framerate" in self.annotations:
            return int(self.annotations["framerate"])
        raise ValueError(
            "framerate not in annotations; pass framerate= explicitly"
        )

    def split_annotations(self, split_idx: int) -> List[Dict]:
        begin, end = self.splits[split_idx]
        fps = self.framerate
        return self.annotations["timesteps"][begin * fps : end * fps]

    def build_split_video(self, split_idx: int) -> Video:
        """Annotations of one split -> a Video (frames attached separately
        by the frame-extraction step)."""
        intrinsics = self.annotations["camera_intrinsics"]
        height = int(intrinsics["image_height"])
        width = int(intrinsics["image_width"])
        focal = focal_from_fov(height, float(intrinsics["y_fov"]))
        timesteps = self.split_annotations(split_idx)

        cameras, object_poses, boxes, validity = [], [], [], []
        for entry in timesteps:
            camera_pose = annotation_to_pose(entry["camera"], self.world_center)
            cameras.append(camera_pose)
            c2w = geometry.pose_to_matrix(
                camera_pose.rotation, camera_pose.translation
            )
            w2c = geometry.invert_pose(c2w)

            objects = sorted(
                entry["entities"]["objects"], key=lambda o: o["uuid"]
            )
            frame_poses, frame_boxes, frame_valid = [], [], []
            for obj in objects:
                pose = annotation_to_pose(obj, self.world_center)
                frame_poses.append(pose)
                o2w = geometry.pose_to_matrix(pose.rotation, pose.translation)
                ltrb, valid = geometry.project_box_to_image(
                    PLAYER_BOX, o2w, w2c, focal, height, width
                )
                frame_boxes.append(ltrb)
                frame_valid.append(valid)
            object_poses.append(frame_poses)
            # Disk layout: (4, objects) per frame (dataset/video.py:24-39).
            boxes.append(np.stack(frame_boxes, axis=-1))
            validity.append(np.asarray(frame_valid))

        n = len(timesteps)
        video = Video()
        video.add_content(
            frames=[None] * n,
            actions=[0] * n,
            rewards=[0] * n,
            metadata=list(timesteps),
            dones=[False] * n,
            cameras=cameras,
            focals=[focal] * n,
            bounding_boxes=boxes,
            bounding_boxes_validity=validity,
            object_poses=object_poses,
        )
        return video

    def export(
        self,
        output_root: str,
        begin_index: int = 0,
        extract_frames: bool = True,
    ) -> List[str]:
        """Write every split as <output_root>/<index>/<camera 0>/ in the
        dataset format; returns the split directories."""
        os.makedirs(output_root, exist_ok=True)
        written = []
        for split_idx in range(len(self.splits)):
            video = self.build_split_video(split_idx)
            split_dir = os.path.join(
                output_root, f"{begin_index + split_idx:05d}"
            )
            camera_dir = os.path.join(split_dir, "00000")
            os.makedirs(camera_dir, exist_ok=True)
            if extract_frames and self.video_file is not None:
                from playableenvironments_tpu_torch.acquisition.sequence_extraction import (
                    extract_clip_frames,
                )

                begin, end = self.splits[split_idx]
                extract_clip_frames(
                    self.video_file, camera_dir, begin, end,
                    expected_frames=video.frames_count,
                )
            video.save(camera_dir, exists_ok=True)
            written.append(split_dir)
        return written
