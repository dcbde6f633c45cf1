"""3D scene debug visualization: object boxes, camera poses, sampled rays.

Port of playableenvironments_tpu/utils/scene_viewer.py, which replaces
utils/lib_3d/scene_viewer.py (pyrender window) with a headless matplotlib-3D
snapshot. The card's machine has no matplotlib, so the port computes what
the JAX module hands matplotlib (`scene_geometry`: each box's 12 edges after
its object-to-world pose, the camera points, the strided ray segments, in
the JAX module's drawing order) and draws it with Pillow through a fixed
projection: matplotlib's default 3-D view (elevation 30 degrees, azimuth
-60), orthographic, fitted to a 7 x 7 inch figure at 110 dpi.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

_BOX_EDGES = (
    (0, 1), (0, 2), (1, 3), (2, 3),  # bottom face
    (4, 5), (4, 6), (5, 7), (6, 7),  # top face
    (0, 4), (1, 5), (2, 6), (3, 7),  # verticals
)
# matplotlib's "tab10" colours, which the JAX module gives box i (i % 10).
TAB10 = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189), (140, 86, 75),
         (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207))
SIZE = 770  # 7 inches at 110 dpi
ELEVATION, AZIMUTH = 30.0, -60.0


def _box_corners(box: np.ndarray) -> np.ndarray:
    """(3, 2) AABB -> (8, 3) corners, bit i of the index selecting hi/lo."""
    corners = []
    for ix in range(2):
        for iy in range(2):
            for iz in range(2):
                corners.append([box[0][ix], box[1][iy], box[2][iz]])
    # order: z fastest -> matches _BOX_EDGES above with (x, y) outer
    return np.asarray(corners, np.float32)[
        [0, 2, 4, 6, 1, 3, 5, 7]
    ]


def scene_geometry(
    boxes: Sequence[np.ndarray],
    o2w_matrices: Optional[Sequence[np.ndarray]] = None,
    camera_positions: Optional[np.ndarray] = None,
    ray_origins: Optional[np.ndarray] = None,
    ray_directions: Optional[np.ndarray] = None,
    ray_length: float = 10.0,
    max_rays: int = 64,
) -> Dict[str, object]:
    """What the JAX module plots, in f32 as it computes it:
    {"boxes": per object its (12, 2, 3) edge segments, "labels": per object
    its label point (the corners' mean), "cameras": (n, 3) camera centers or
    None, "rays": (m, 2, 3) ray segments of `ray_length` from every
    stride-th origin (stride = rays // max_rays, at least 1)}. Its figure's
    lines are the boxes' edges, object by object, then the rays."""
    out: Dict[str, object] = {"boxes": [], "labels": [], "cameras": None, "rays": np.zeros((0, 2, 3), np.float32)}
    for i, box in enumerate(boxes):
        corners = _box_corners(np.asarray(box, np.float32))
        if o2w_matrices is not None:
            m = np.asarray(o2w_matrices[i], np.float32)
            corners = corners @ m[:3, :3].T + m[:3, 3]
        out["boxes"].append(np.stack([np.stack([corners[a], corners[b]]) for a, b in _BOX_EDGES]))
        out["labels"].append(corners.mean(0))
    if camera_positions is not None:
        out["cameras"] = np.reshape(np.asarray(camera_positions, np.float32), (-1, 3))
    if ray_origins is not None and ray_directions is not None:
        origins = np.reshape(np.asarray(ray_origins, np.float32), (-1, 3))
        dirs = np.reshape(np.asarray(ray_directions, np.float32), (-1, 3))
        if origins.shape[0] == 1 and dirs.shape[0] > 1:
            origins = np.broadcast_to(origins, dirs.shape)
        stride = max(dirs.shape[0] // max_rays, 1)
        segments = [np.stack([o, o + d / (np.linalg.norm(d) + 1e-8) * ray_length])
                    for o, d in zip(origins[::stride], dirs[::stride])]
        if segments:
            out["rays"] = np.stack(segments)
    return out


def _projection(points: np.ndarray) -> np.ndarray:
    """(..., 3) world points -> (..., 2) view-plane coordinates (right, up)
    of an orthographic camera at ELEVATION above the x-y plane and AZIMUTH
    about z, as matplotlib's default 3-D view looks at the scene."""
    elev, azim = np.radians(ELEVATION), np.radians(AZIMUTH)
    right = np.asarray([-np.sin(azim), np.cos(azim), 0.0])
    up = np.asarray([-np.sin(elev) * np.cos(azim), -np.sin(elev) * np.sin(azim), np.cos(elev)])
    return np.stack([points @ right, points @ up], axis=-1)


def view_scene(
    boxes: Sequence[np.ndarray],
    o2w_matrices: Optional[Sequence[np.ndarray]] = None,
    camera_positions: Optional[np.ndarray] = None,
    ray_origins: Optional[np.ndarray] = None,
    ray_directions: Optional[np.ndarray] = None,
    ray_length: float = 10.0,
    max_rays: int = 64,
    output_path: Optional[str] = None,
):
    """Render a 3D snapshot of the scene layout.

    :param boxes: per object (3, 2) object-frame AABBs.
    :param o2w_matrices: optional per object (4, 4) object-to-world poses.
    :param camera_positions: optional (n, 3) camera centers.
    :param ray_origins: optional (..., 3) world ray origins.
    :param ray_directions: optional (..., 3) world ray directions.
    :param output_path: if set, save a PNG there and return the path;
        otherwise return the Pillow image.
    """
    import os

    from PIL import Image, ImageDraw

    geometry = scene_geometry(boxes, o2w_matrices, camera_positions, ray_origins, ray_directions, ray_length,
                              max_rays)
    everything: List[np.ndarray] = [b.reshape(-1, 3) for b in geometry["boxes"]] + [geometry["rays"].reshape(-1, 3)]
    if geometry["cameras"] is not None:
        everything.append(geometry["cameras"])
    points = np.concatenate(everything) if everything else np.zeros((0, 3), np.float32)
    flat = _projection(points.astype(np.float64)) if len(points) else np.zeros((1, 2))
    lo, hi = flat.min(0), flat.max(0)
    margin = 40
    scale = (SIZE - 2 * margin) / max(float((hi - lo).max()), 1e-6)
    centre = (lo + hi) / 2

    def pixel(p):
        u, v = (_projection(np.asarray(p, np.float64)) - centre) * scale
        return float(SIZE / 2 + u), float(SIZE / 2 - v)

    image = Image.new("RGB", (SIZE, SIZE), (255, 255, 255))
    draw = ImageDraw.Draw(image, "RGBA")
    for i, (edges, label) in enumerate(zip(geometry["boxes"], geometry["labels"])):
        colour = TAB10[i % 10]
        for a, b in edges:
            draw.line([pixel(a), pixel(b)], fill=colour, width=1)
        draw.text(pixel(label), f"obj {i}", fill=colour)
    if geometry["cameras"] is not None:
        for c in geometry["cameras"]:
            x, y = pixel(c)
            draw.polygon([(x, y - 5), (x - 4, y + 3), (x + 4, y + 3)], fill=(0, 0, 0))
    for a, b in geometry["rays"]:
        draw.line([pixel(a), pixel(b)], fill=(128, 128, 128, 153), width=1)
    draw.text((8, SIZE - 16), f"x, y, z; elevation {ELEVATION:.0f}, azimuth {AZIMUTH:.0f}", fill=(0, 0, 0))
    if output_path is not None:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        image.save(output_path)
        return output_path
    return image
