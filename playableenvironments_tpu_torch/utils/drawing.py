"""Frame annotation drawing: 2D boxes and projected 3D object axes, and
feature-map dumps.

Port of playableenvironments_tpu/utils/drawing.py. Replaces
utils/drawing/bounding_box_drawer.py + the box/axes overlays of
image_helper.py:144-343 with cv2 primitives: `draw_boxes` and `draw_axes`
are copies of the JAX package's. `save_feature_maps` writes what the JAX
package's matplotlib call (`plt.imsave` of `plt.cm.jet`) writes, with
matplotlib's "jet" colormap as a NumPy table (`jet_table`) and Pillow,
since the card's machine has no matplotlib."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_COLORS = (
    (230, 60, 60), (60, 200, 80), (70, 110, 240), (240, 200, 60),
    (200, 80, 220), (80, 220, 220),
)


def _as_uint8(frame: np.ndarray) -> np.ndarray:
    if frame.dtype == np.uint8:
        return frame.copy()
    return np.clip(np.asarray(frame) * 255.0, 0, 255).astype(np.uint8)


def draw_boxes(
    frame: np.ndarray,
    boxes: np.ndarray,
    validity: Optional[np.ndarray] = None,
    labels: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Draw normalized ltrb boxes onto a frame.

    :param frame: (H, W, 3) float [0,1] or uint8.
    :param boxes: (N, 4) normalized (left, top, right, bottom).
    :return: (H, W, 3) uint8 annotated copy.
    """
    import cv2

    img = _as_uint8(frame)
    h, w = img.shape[:2]
    for i, box in enumerate(np.asarray(boxes)):
        if validity is not None and not validity[i]:
            continue
        color = _COLORS[i % len(_COLORS)]
        p0 = (int(box[0] * w), int(box[1] * h))
        p1 = (int(box[2] * w), int(box[3] * h))
        cv2.rectangle(img, p0, p1, color, 1)
        if labels is not None:
            cv2.putText(img, str(labels[i]), (p0[0], max(p0[1] - 3, 8)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.3, color, 1)
    return img


def draw_axes(
    frame: np.ndarray,
    o2w: np.ndarray,
    w2c: np.ndarray,
    focal: float,
    axis_length: float = 1.0,
) -> np.ndarray:
    """Project and draw an object's coordinate axes (x red, y green, z blue)
    through an OpenGL camera (-z forward), the image_helper draw_axes overlay.

    :param o2w: (4, 4) object-to-world pose.
    :param w2c: (4, 4) world-to-camera matrix.
    """
    import cv2

    img = _as_uint8(frame)
    h, w = img.shape[:2]
    points = np.asarray(
        [[0.0, 0, 0], [axis_length, 0, 0], [0, axis_length, 0],
         [0, 0, axis_length]]
    )
    world = points @ np.asarray(o2w)[:3, :3].T + np.asarray(o2w)[:3, 3]
    cam = world @ np.asarray(w2c)[:3, :3].T + np.asarray(w2c)[:3, 3]
    # Sign-preserving near-zero clamp: in front of the camera is z < 0
    # (OpenGL); forcing small positive z negative would flip a
    # behind-camera point to in-front.
    z = np.where(
        np.abs(cam[:, 2]) < 1e-8, np.where(cam[:, 2] > 0, 1e-8, -1e-8), cam[:, 2]
    )
    proj = -cam[:, :2] / z[:, None] * focal
    proj[:, 1] *= -1
    proj += np.asarray([w / 2.0, h / 2.0])
    origin = tuple(int(v) for v in proj[0])
    # RGB constants (frames flow RGB through the codebase; save_video
    # converts to BGR only at encode time): x red, y green, z blue.
    for idx, (end, color) in enumerate(
        zip(proj[1:], ((230, 0, 0), (0, 200, 0), (0, 0, 230)))
    ):
        # Draw only when BOTH endpoints are in front of the camera: a
        # behind-camera endpoint projects with flipped sign, drawing a
        # spurious mirrored line through the image center.
        if cam[0, 2] < 0 and cam[idx + 1, 2] < 0:
            cv2.line(img, origin, tuple(int(v) for v in end), color, 1)
    return img


# matplotlib's "jet" (matplotlib/_cm.py::_jet_data): per channel, the
# (x, value below x, value above x) points of its piecewise-linear segments.
_JET_SEGMENTS = (
    ((0.0, 0.0, 0.0), (0.35, 0.0, 0.0), (0.66, 1.0, 1.0), (0.89, 1.0, 1.0), (1.0, 0.5, 0.5)),
    ((0.0, 0.0, 0.0), (0.125, 0.0, 0.0), (0.375, 1.0, 1.0), (0.64, 1.0, 1.0), (0.91, 0.0, 0.0), (1.0, 0.0, 0.0)),
    ((0.0, 0.5, 0.5), (0.11, 1.0, 1.0), (0.34, 1.0, 1.0), (0.65, 0.0, 0.0), (1.0, 0.0, 0.0)),
)


def jet_table(entries: int = 256) -> np.ndarray:
    """(entries, 4) RGBA in [0, 1]: matplotlib's "jet" lookup table, built
    from its segment data as matplotlib.colors._create_lookup_table builds
    it (gamma 1), alpha 1."""
    x_new = (entries - 1) * np.linspace(0.0, 1.0, entries)
    table = np.ones((entries, 4))
    for channel, segments in enumerate(_JET_SEGMENTS):
        data = np.asarray(segments)
        x, below, above = data[:, 0] * (entries - 1), data[:, 1], data[:, 2]
        ind = np.searchsorted(x, x_new)[1:-1]
        distance = (x_new[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        values = np.concatenate([[above[0]], distance * (below[ind] - above[ind - 1]) + above[ind - 1], [below[-1]]])
        table[:, channel] = np.clip(values, 0.0, 1.0)
    return table


def jet_colors(values: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> (..., 4) uint8 RGBA as `plt.imsave(path,
    plt.cm.jet(values))` stores them: the index is the value times the
    table's 256 entries, truncated (1 takes the last entry), and each float
    channel times 255, truncated."""
    table = jet_table()
    index = np.array(values, copy=True)
    index *= len(table)
    index[index == len(table)] = len(table) - 1
    rgba = table.take(index.astype(int), axis=0, mode="clip")
    return (rgba * 255).astype(np.uint8)


def save_feature_maps(features: np.ndarray, output_dir: str):
    """Save each feature channel as a jet-colormapped PNG
    (utils/drawing/autoencoder_features_drawer.py:10-44's per-channel dump,
    used to inspect the VAE's latent feature maps), `<index:05d>.png` RGBA.

    :param features: (channels, height, width) array.
    """
    import os

    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    features = np.asarray(features, np.float32)
    lo = features.min(axis=(1, 2), keepdims=True)
    hi = features.max(axis=(1, 2), keepdims=True)
    normalized = (features - lo) / np.maximum(hi - lo, 1e-12)
    for idx in range(normalized.shape[0]):
        Image.fromarray(jet_colors(normalized[idx]), "RGBA").save(os.path.join(output_dir, f"{idx:05d}.png"))
