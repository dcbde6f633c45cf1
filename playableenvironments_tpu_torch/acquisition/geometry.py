"""Host-side (numpy) 3D helpers for the offline acquisition pipeline.

Copy of playableenvironments_tpu/acquisition/geometry.py (the port imports
nothing of the JAX package).

Same conventions as core.transforms3d (R = Ry @ Rx @ Rz, OpenGL camera
looking down -z); numpy because acquisition runs on the host against files,
where per-op device dispatch would dominate.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def euler_to_matrix(rotation: Sequence[float]) -> np.ndarray:
    """(3,) xyz Euler angles -> (3, 3) rotation, R = Ry @ Rx @ Rz."""
    x, y, z = rotation
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rx = np.asarray([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float64)
    ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    rz = np.asarray([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float64)
    return ry @ rx @ rz


def pose_to_matrix(
    rotation: Sequence[float], translation: Sequence[float]
) -> np.ndarray:
    """Euler + translation -> homogeneous (4, 4)."""
    m = np.eye(4)
    m[:3, :3] = euler_to_matrix(rotation)
    m[:3, 3] = translation
    return m


def matrix_to_euler_translation(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of pose_to_matrix (|x| < pi/2 branch, matching
    core.transforms3d.matrix_to_euler_translation)."""
    r = m[:3, :3]
    x = np.arcsin(np.clip(-r[1, 2], -1.0, 1.0))
    y = np.arctan2(r[0, 2], r[2, 2])
    z = np.arctan2(r[1, 0], r[1, 1])
    return np.asarray([x, y, z]), m[:3, 3].copy()


def invert_pose(m: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    r = m[:3, :3].T
    out[:3, :3] = r
    out[:3, 3] = -r @ m[:3, 3]
    return out


def transform_points(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(n, 3) points through a (4, 4) homogeneous transform."""
    return points @ m[:3, :3].T + m[:3, 3]


def project_box_to_image(
    box: np.ndarray,
    o2w: np.ndarray,
    w2c: np.ndarray,
    focal: float,
    height: int,
    width: int,
) -> Tuple[np.ndarray, bool]:
    """Project a 3D AABB into a normalized 2D ltrb box.

    Semantics match the minecraft acquisition's box projection
    (splitted_recording.py:86-165): the 8 corners plus the object origin
    (the feet) are projected through an OpenGL camera (-z forward), bottom
    comes from the feet point, boxes are clamped to [0, 1] and an off-screen
    or behind-camera box is reported invalid with a centered placeholder.
    """
    lo = box[:, 0]
    hi = box[:, 1]
    corners = np.asarray(
        [[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]], [lo[0], hi[1], lo[2]],
         [lo[0], hi[1], hi[2]], [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
         [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]], [0.0, 0.0, 0.0]]
    )
    world = transform_points(corners, o2w)
    cam = transform_points(world, w2c)

    z = cam[:, 2]
    # ANY corner behind the camera invalidates the box: dividing a
    # behind-camera corner by its (positive) z flips the projection's sign,
    # so the min/max over a mixed corner set is garbage that would clip into
    # [0, 1] and pass as a plausible-looking box.
    behind = np.any(z > 0)
    safe_z = np.where(np.abs(z) < 1e-8, -1e-8, z)
    projected = -cam[:, :2] / safe_z[:, None] * focal
    projected[:, 1] *= -1  # image rows grow downward

    left = projected[:, 0].min()
    right = projected[:, 0].max()
    top = projected[:, 1].min()
    bottom = projected[-1, 1]  # feet point

    ltrb = np.asarray(
        [
            (left + width / 2) / width,
            (top + height / 2) / height,
            (right + width / 2) / width,
            (bottom + height / 2) / height,
        ]
    )
    ltrb = np.clip(ltrb, 0.0, 1.0)
    valid = not behind and ltrb[0] != ltrb[2] and ltrb[1] != ltrb[3]
    if not valid:
        ltrb = np.asarray([0.25, 0.25, 0.75, 0.75])
    return ltrb.astype(np.float32), bool(valid)
