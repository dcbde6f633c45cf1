"""Video/GIF export and frame overlays.

Port of playableenvironments_tpu/utils/video_io.py: mp4 through cv2's
VideoWriter, gif and PNG frames through Pillow. `cv2` is imported only
where an mp4 is written or an overlay drawn; where it is not installed,
`save_video` raises the RuntimeError that a missing codec raises, so that a
caller that skips the mp4 for a missing codec (the play CLI, the playable
evaluator) skips it for a missing cv2 too, and still writes frames and gif.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _to_uint8(frame: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(frame) * 255.0, 0, 255).astype(np.uint8)


def _cv2():
    try:
        import cv2
    except ImportError as error:
        raise RuntimeError(f"cv2 is not installed ({error}); no mp4 encoder") from error
    return cv2


def draw_action_overlay(frame: np.ndarray, action: Optional[int] = None, timecode: Optional[str] = None) -> np.ndarray:
    """Stamp the chosen action / timecode onto a frame."""
    cv2 = _cv2()
    img = _to_uint8(frame).copy()
    if action is not None:
        cv2.putText(img, f"A{action}", (4, 16), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1, cv2.LINE_AA)
    if timecode is not None:
        cv2.putText(img, timecode, (4, img.shape[0] - 6), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1,
                    cv2.LINE_AA)
    return img.astype(np.float32) / 255.0


def save_video(frames: Sequence[np.ndarray], path: str, framerate: int = 5, actions: Optional[Sequence[int]] = None):
    """Encode frames ((H, W, 3) float [0, 1]) to mp4 with cv2's VideoWriter.
    Raises RuntimeError without cv2 or without its mp4v codec."""
    cv2 = _cv2()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not len(frames):
        raise ValueError("save_video: no frames to encode")
    h, w = np.asarray(frames[0]).shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), framerate, (w, h))
    if not writer.isOpened():
        # An unopened writer (a missing codec) raises nothing and would leave
        # an empty file behind.
        raise RuntimeError(f"cv2.VideoWriter could not open {path} (mp4v codec missing?)")
    try:
        for idx, frame in enumerate(frames):
            if actions is not None and idx < len(actions):
                frame = draw_action_overlay(frame, actions[idx])
            writer.write(cv2.cvtColor(_to_uint8(frame), cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    return path


def save_gif(frames: Sequence[np.ndarray], path: str, framerate: int = 5):
    """Palette gif via Pillow."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    images = [Image.fromarray(_to_uint8(f)) for f in frames]
    images[0].save(path, save_all=True, append_images=images[1:], duration=int(1000 / framerate), loop=0)
    return path


def save_frames(frames: Sequence[np.ndarray], directory: str, prefix: str = ""):
    """One PNG a frame."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    paths = []
    for idx, frame in enumerate(frames):
        p = os.path.join(directory, f"{prefix}{idx:05}.png")
        Image.fromarray(_to_uint8(frame)).save(p)
        paths.append(p)
    return paths
