"""Synthetic tiny dataset generator.

Copy of playableenvironments_tpu/data/synthetic.py (the port imports
nothing of the JAX package), used by the port's tests and smoke runs.

Real datasets are external downloads (reference README.md:46); tests and smoke
configs need data, so this renders a minimal tennis-like scene analytically:
a green ground plane (z = 0, tennis convention), a sky, and one moving
"player" box standing on the ground, viewed by a tilted pinhole camera.
Frames, camera poses, focals, and normalized bounding boxes all follow the
reference on-disk format via data.video.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from playableenvironments_tpu_torch.data.video import (
    MulticameraVideo,
    PoseParametersNumpy,
    Video,
)

GROUND_COLOR = np.asarray([0.2, 0.5, 0.2], np.float32)
SKY_COLOR = np.asarray([0.5, 0.7, 0.9], np.float32)
PLAYER_COLOR = np.asarray([0.8, 0.2, 0.2], np.float32)
PLAYER_SIZE = (0.8, 0.8, 1.8)  # x, y extent and height (z up)


def _euler_matrix(rotation: np.ndarray) -> np.ndarray:
    """(3,) xyz Euler angles -> (3, 3) rotation, R = Ry @ Rx @ Rz: the
    framework's z->x->y convention (a copy of the JAX package's
    acquisition.geometry.euler_to_matrix), in float64."""
    x, y, z = np.asarray(rotation, np.float64)
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rx = np.asarray([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float64)
    ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    rz = np.asarray([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float64)
    return ry @ rx @ rz


def _ground_point(xy: Tuple[float, float], height: float, up_axis: int) -> np.ndarray:
    """The world point at ground coordinates `xy` (the two axes other than
    `up_axis`, in order) and `height` along `up_axis`."""
    point = np.zeros(3, np.float32)
    point[[a for a in range(3) if a != up_axis]] = xy
    point[up_axis] = height
    return point


def render_frame(
    player_xy: Tuple[float, float],
    camera_rotation: np.ndarray,
    camera_translation: np.ndarray,
    focal: float,
    height: int,
    width: int,
    up_axis: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic render: per-pixel ray vs ground plane and player cuboid.

    :param player_xy: the player's ground coordinates (the axes other than
        `up_axis`); :param up_axis: 2 (z up, tennis) or 1 (y up, Minecraft).
    :return: ((H, W, 3) image, (4,) normalized (l, t, r, b) player box).
    """
    rot = _euler_matrix(camera_rotation)
    rows, cols = np.mgrid[0:height, 0:width]
    dirs_cam = np.stack(
        [
            (cols - width / 2) / focal,
            -(rows - height / 2) / focal,
            -np.ones_like(cols, dtype=np.float32),
        ],
        axis=-1,
    ).astype(np.float32)
    dirs_world = dirs_cam @ rot.T
    origin = np.asarray(camera_translation, np.float32)

    image = np.broadcast_to(SKY_COLOR, (height, width, 3)).copy()

    # Ground plane: 0 along the up axis.
    dz = dirs_world[..., up_axis]
    t_ground = np.where(np.abs(dz) > 1e-6, -origin[up_axis] / dz, np.inf)
    ground_hit = (t_ground > 0) & np.isfinite(t_ground)
    image[ground_hit] = GROUND_COLOR

    # Player cuboid standing on the ground at player_xy: slab test.
    sx, sy, sz = PLAYER_SIZE
    low = _ground_point((player_xy[0] - sx / 2, player_xy[1] - sy / 2), 0.0, up_axis)
    high = _ground_point((player_xy[0] + sx / 2, player_xy[1] + sy / 2), sz, up_axis)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (low - origin) / dirs_world
        t2 = (high - origin) / dirs_world
    t_near = np.nanmax(np.minimum(t1, t2), axis=-1)
    t_far = np.nanmin(np.maximum(t1, t2), axis=-1)
    player_hit = (t_far > t_near) & (t_far > 0)
    # Player visible in front of the ground intersection.
    visible = player_hit & (t_near < t_ground)
    image[visible] = PLAYER_COLOR

    # Bounding box from projected cuboid corners.
    corners = np.stack(
        [np.where(np.asarray(m), high, low) for m in
         [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
          (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]]
    ).astype(np.float32)
    cam_pts = (corners - origin) @ rot  # world -> camera (R^T)
    z = np.where(np.abs(cam_pts[:, 2]) < 1e-6, -1e-6, cam_pts[:, 2])
    u = -cam_pts[:, 0] / z * focal + width / 2
    v = cam_pts[:, 1] / z * focal + height / 2
    box = np.asarray(
        [u.min() / width, v.min() / height, u.max() / width, v.max() / height],
        np.float32,
    )
    return image.astype(np.float32), np.clip(box, 0.0, 1.0)


def make_synthetic_dataset(
    root: str,
    videos: int = 2,
    frames: int = 12,
    height: int = 32,
    width: int = 48,
    cameras: int = 1,
    focal: float = 35.0,
    seed: int = 0,
    splits: Sequence[str] = ("train", "validation", "test"),
) -> str:
    """Write a reference-format dataset tree with train/validation/test splits.

    The player follows a smooth random walk on the ground; per-frame action
    labels record its quantized movement direction (4 actions), giving the
    action-space metrics something learnable.
    """
    rng = np.random.default_rng(seed)
    # World: z up, ground plane z = 0 (tennis convention). A camera with
    # identity rotation looks along world -z (straight down); pitching about x
    # by ~1.05 rad turns the view toward +y across the court.
    camera_rotation = np.asarray([1.05, 0.0, 0.0], np.float32)
    camera_translation = np.asarray([0.0, -9.0, 7.0], np.float32)

    for split in splits:
        split_dir = os.path.join(root, split)
        os.makedirs(split_dir, exist_ok=True)
        for video_idx in range(videos):
            pos = rng.uniform(-2.0, 2.0, size=2).astype(np.float32)
            velocity = np.zeros(2, np.float32)
            frames_list, boxes, validity, actions = [], [], [], []
            for _ in range(frames):
                velocity = 0.7 * velocity + 0.3 * rng.uniform(-0.6, 0.6, 2)
                pos = np.clip(pos + velocity, -3.0, 3.0)
                action = int(
                    np.argmax([velocity[1], -velocity[1], velocity[0], -velocity[0]])
                )
                image, box = render_frame(
                    (pos[0], pos[1]), camera_rotation, camera_translation,
                    focal, height, width,
                )
                frames_list.append(image)
                boxes.append(box[:, None])  # disk layout (4, objects)
                validity.append(np.asarray([True]))
                actions.append(action)

            video = Video().add_content(
                frames=frames_list,
                actions=actions,
                rewards=[0.0] * frames,
                metadata=[{} for _ in range(frames)],
                dones=[False] * (frames - 1) + [True],
                cameras=[
                    PoseParametersNumpy(camera_rotation, camera_translation)
                ] * frames,
                focals=[focal] * frames,
                bounding_boxes=boxes,
                bounding_boxes_validity=validity,
            )
            multicam = MulticameraVideo([video] * cameras)
            multicam.save(
                os.path.join(split_dir, f"{video_idx:05}"), exists_ok=True
            )
    return root


PLAYER_2_COLOR = np.asarray([0.2, 0.2, 0.8], np.float32)


def make_two_player_dataset(
    root: str,
    videos: int = 2,
    frames: int = 12,
    height: int = 32,
    width: int = 48,
    focal: float = 35.0,
    focal_length_multiplier: float = 1.0,
    camera_rotation: Sequence[float] = (1.05, 0.0, 0.0),
    camera_translation: Sequence[float] = (0.0, -9.0, 7.0),
    player_ranges: Sequence[Tuple[Tuple[float, float], Tuple[float, float]]] = (
        ((-2.0, 2.0), (-3.0, -0.5)), ((-2.0, 2.0), (0.5, 3.0))),
    seed: int = 0,
    splits: Sequence[str] = ("train", "validation", "test"),
    frames_by_split: Optional[dict] = None,
    up_axis: int = 2,
) -> str:
    """A 1-camera dataset with two players (the tennis scenes' two dynamic
    objects), each on its own smooth random walk inside its range of ground
    coordinates, drawn as in `make_synthetic_dataset` (player 2 in blue over
    player 1's frame) with one box per player a frame and actions from
    player 1's movement.

    :param focal: the focal stored with each frame (pixels of the frames
        the dataset's focals refer to); frames are rendered with
        focal * focal_length_multiplier.
    :param player_ranges: per player, the ranges of its two ground
        coordinates (the axes other than `up_axis`, in order).
    :param frames_by_split: optional {split: (videos, frames)} overriding
        `videos` and `frames` per split.
    :param up_axis: 2 for the tennis geometry (z up), 1 for Minecraft's
        (y up; `MINECRAFT_GEOMETRY` holds the rest of it).
    """
    rng = np.random.default_rng(seed)
    rotation = np.asarray(camera_rotation, np.float32)
    translation = np.asarray(camera_translation, np.float32)
    lows = np.asarray([[r[0][0], r[1][0]] for r in player_ranges], np.float32)
    highs = np.asarray([[r[0][1], r[1][1]] for r in player_ranges], np.float32)
    for split in splits:
        split_videos, split_frames = (frames_by_split or {}).get(split, (videos, frames))
        for video_idx in range(split_videos):
            pos = rng.uniform(lows, highs).astype(np.float32)
            velocity = np.zeros_like(pos)
            images, boxes, actions = [], [], []
            for _ in range(split_frames):
                velocity = 0.7 * velocity + 0.3 * rng.uniform(-0.6, 0.6, pos.shape)
                pos = np.clip(pos + velocity, lows, highs)
                actions.append(int(np.argmax([velocity[0, 1], -velocity[0, 1], velocity[0, 0], -velocity[0, 0]])))
                image, box_1 = render_frame(tuple(pos[0]), rotation, translation, focal * focal_length_multiplier,
                                            height, width, up_axis)
                image_2, box_2 = render_frame(tuple(pos[1]), rotation, translation,
                                              focal * focal_length_multiplier, height, width, up_axis)
                image[np.all(image_2 == PLAYER_COLOR, axis=-1)] = PLAYER_2_COLOR
                images.append(image)
                boxes.append(np.stack([box_1, box_2], axis=-1))  # disk layout (4, objects)
            video = Video().add_content(
                frames=images,
                actions=actions,
                rewards=[0.0] * split_frames,
                metadata=[{} for _ in range(split_frames)],
                dones=[False] * (split_frames - 1) + [True],
                cameras=[PoseParametersNumpy(rotation, translation)] * split_frames,
                focals=[focal] * split_frames,
                bounding_boxes=boxes,
                bounding_boxes_validity=[np.asarray([True, True])] * split_frames,
            )
            MulticameraVideo([video]).save(os.path.join(root, split, f"{video_idx:05}"), exists_ok=True)
    return root


# make_two_player_dataset's arguments for the Minecraft geometry
# (configs/minecraft.yaml): y up, the focal multiplier 0.5, a camera yawed
# away from the world axes (the learned pose encoder adds its yaw offset to
# the camera's), and two players whose 0.8 x 1.8 x 0.8 cuboids fit the
# player box [-0.6, 0.6] x [0, 2.1] x [-1.2, 1.2] and stand inside the
# background's slab [-10, 10] x [-0.6, 2] x [-10, 10], in view.
MINECRAFT_GEOMETRY = dict(
    up_axis=1,
    focal_length_multiplier=0.5,
    camera_rotation=(-0.35, 0.3, 0.0),
    camera_translation=(3.0, 3.5, 9.0),
    player_ranges=(((-2.0, 0.5), (-2.5, 1.0)), ((0.5, 3.0), (-2.5, 1.0))),
)
