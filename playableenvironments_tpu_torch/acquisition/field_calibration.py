"""Camera calibration from a known planar field (pure numpy).

Copy of playableenvironments_tpu/acquisition/field_calibration.py (the port imports
nothing of the JAX package).

Replaces dataset/calibration/tennis/field_calibrator.py (OpenCV
calibrateCameraExtended) with a dependency-free closed-form solve: DLT
homography from the court plane to the image, Zhang-style focal recovery
from the homography's orthogonality constraints, pose decomposition, and
conversion to the framework's OpenGL camera convention (camera faces -z;
c2w = cv_c2w rotated pi about x).

Output contract matches the reference: (3,) c2w Euler rotations, (3,) c2w
translation, focal length in pixels — the per-frame camera annotations the
tennis pipeline writes (compute_camera_poses_2.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from playableenvironments_tpu_torch.acquisition.geometry import (
    invert_pose,
    matrix_to_euler_translation,
    pose_to_matrix,
)


def homography_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares homography src (n, 2) -> dst (n, 2), Hartley-normalized."""

    def normalization(points):
        mean = points.mean(0)
        scale = np.sqrt(2.0) / max(np.linalg.norm(points - mean, axis=1).mean(), 1e-12)
        t = np.asarray(
            [[scale, 0, -scale * mean[0]], [0, scale, -scale * mean[1]], [0, 0, 1]]
        )
        return t

    t_src = normalization(src)
    t_dst = normalization(dst)
    ones = np.ones((len(src), 1))
    s = np.concatenate([src, ones], 1) @ t_src.T
    d = np.concatenate([dst, ones], 1) @ t_dst.T

    rows = []
    for (x, y, _), (u, v, _) in zip(s, d):
        rows.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        rows.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, vt = np.linalg.svd(np.asarray(rows))
    h = vt[-1].reshape(3, 3)
    h = np.linalg.inv(t_dst) @ h @ t_src
    return h / h[2, 2]


def _project(world_points, image_size, rotation, translation, focal):
    width, height = image_size
    c2w = pose_to_matrix(rotation, translation)
    w2c = invert_pose(c2w)
    cam = world_points @ w2c[:3, :3].T + w2c[:3, 3]
    projected = -cam[:, :2] / cam[:, 2:3] * focal
    projected = projected * np.asarray([1.0, -1.0])
    return projected + np.asarray([width / 2.0, height / 2.0])


def _refine(world_points, image_points, image_size, rotation, translation,
            focal, iterations: int = 30):
    """Levenberg-Marquardt on (rotation, translation, focal) minimizing pixel
    reprojection error — the role OpenCV's calibrateCamera LM loop plays in
    the reference. Numeric Jacobian: 7 parameters, ~19 points."""
    params = np.concatenate([rotation, translation, [focal]]).astype(np.float64)

    def residuals(p):
        return (
            _project(world_points, image_size, p[:3], p[3:6], p[6])
            - image_points
        ).ravel()

    lam = 1e-3
    r = residuals(params)
    cost = float(r @ r)
    for _ in range(iterations):
        jac = np.empty((r.size, params.size))
        for j in range(params.size):
            eps = 1e-6 * max(abs(params[j]), 1.0)
            bumped = params.copy()
            bumped[j] += eps
            jac[:, j] = (residuals(bumped) - r) / eps
        jtj = jac.T @ jac
        jtr = jac.T @ r
        for _ in range(12):
            try:
                delta = np.linalg.solve(jtj + lam * np.diag(np.diag(jtj)), jtr)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            candidate = params - delta
            rc = residuals(candidate)
            candidate_cost = float(rc @ rc)
            if candidate_cost < cost:
                params, r, cost = candidate, rc, candidate_cost
                lam = max(lam * 0.3, 1e-9)
                break
            lam *= 10
        else:
            break
        if cost / r.size < 1e-12:
            break
    return params[:3], params[3:6], float(params[6])


def calibrate_camera(
    world_points: np.ndarray,
    image_points: np.ndarray,
    image_size: Sequence[int],
    refine: bool = True,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Planar calibration with fixed principal point and square pixels.

    :param world_points: (n, 3) field points, z == 0, right-handed with z up.
    :param image_points: (n, 2) pixel correspondences (origin top-left).
    :param image_size: (width, height).
    :return: ((3,) c2w Euler rotations, (3,) c2w translation, focal pixels).
    """
    world_points = np.asarray(world_points, np.float64)
    image_points = np.asarray(image_points, np.float64)
    assert np.allclose(world_points[:, 2], 0.0), "field must be planar (z=0)"
    width, height = image_size

    # Principal point fixed at the image center; work in centered pixels with
    # y DOWN (the OpenCV camera convention the homography decomposes in).
    centered = image_points - np.asarray([width / 2.0, height / 2.0])

    h = homography_dlt(world_points[:, :2], centered)

    # Zhang's constraints with K = diag(f, f, 1):
    # r1 = K^-1 h1 / s, r2 = K^-1 h2 / s  =>  r1.r2 = 0, |r1| = |r2|.
    h1, h2 = h[:, 0], h[:, 1]
    f_candidates = []
    denom = h1[2] * h2[2]
    if abs(denom) > 1e-12:
        f2 = -(h1[0] * h2[0] + h1[1] * h2[1]) / denom
        if f2 > 0:
            f_candidates.append(f2)
    denom = h2[2] ** 2 - h1[2] ** 2
    if abs(denom) > 1e-12:
        f2 = (h1[0] ** 2 + h1[1] ** 2 - h2[0] ** 2 - h2[1] ** 2) / denom
        if f2 > 0:
            f_candidates.append(f2)
    if not f_candidates:
        raise ValueError("degenerate homography: cannot recover focal length")
    focal = float(np.sqrt(np.mean(f_candidates)))

    k_inv = np.diag([1.0 / focal, 1.0 / focal, 1.0])
    r1 = k_inv @ h1
    r2 = k_inv @ h2
    scale = 1.0 / np.linalg.norm(r1)
    r1, r2 = r1 * scale, r2 * scale
    t = (k_inv @ h[:, 2]) * scale
    # The camera must see the field: OpenCV convention has z > 0 in front.
    if t[2] < 0:
        r1, r2, t = -r1, -r2, -t
    r3 = np.cross(r1, r2)
    rotation = np.stack([r1, r2, r3], axis=1)
    # Nearest orthonormal matrix.
    u, _, vt = np.linalg.svd(rotation)
    rotation = u @ vt

    w2c_cv = np.eye(4)
    w2c_cv[:3, :3] = rotation
    w2c_cv[:3, 3] = t
    c2w_cv = invert_pose(w2c_cv)

    # OpenCV camera (z forward, y down) -> OpenGL camera (-z forward, y up):
    # rotate the camera frame pi about x (field_calibrator.py:64-68).
    c2w_gl = c2w_cv @ pose_to_matrix([np.pi, 0.0, 0.0], [0.0, 0.0, 0.0])
    rotations, translations = matrix_to_euler_translation(c2w_gl)
    if refine:
        rotations, translations, focal = _refine(
            world_points, image_points, image_size, rotations, translations,
            focal,
        )
    return rotations.astype(np.float32), translations.astype(np.float32), focal


def reprojection_error(
    world_points: np.ndarray,
    image_points: np.ndarray,
    image_size: Sequence[int],
    c2w_rotation: np.ndarray,
    c2w_translation: np.ndarray,
    focal: float,
) -> float:
    """Mean pixel reprojection error of a recovered calibration (the quality
    gate the tennis pipeline applies before accepting a sequence)."""
    width, height = image_size
    c2w = pose_to_matrix(c2w_rotation, c2w_translation)
    w2c = invert_pose(c2w)
    cam = np.asarray(world_points, np.float64) @ w2c[:3, :3].T + w2c[:3, 3]
    projected = -cam[:, :2] / cam[:, 2:3] * focal
    projected[:, 1] *= -1
    projected += np.asarray([width / 2.0, height / 2.0])
    return float(np.linalg.norm(projected - image_points, axis=1).mean())
