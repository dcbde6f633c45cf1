"""Video-clip frame extraction for the acquisition pipeline.

Copy of playableenvironments_tpu/acquisition/sequence_extraction.py (the port imports
nothing of the JAX package).

Replaces the ffmpeg subprocess splitting in splitted_recording.py:187-228 and
the tennis extract_sequences/extract_frames steps: [start, end) second clips
become 00000.png... frame trees. Prefers a system ffmpeg (fast seek + decode)
and falls back to cv2.VideoCapture when ffmpeg is absent.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import Optional


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def video_framerate(path: str) -> float:
    """Framerate of a video file (ffprobe, else cv2)."""
    if shutil.which("ffprobe"):
        out = subprocess.check_output(
            ["ffprobe", "-v", "error", "-select_streams", "v",
             "-of", "default=noprint_wrappers=1:nokey=1",
             "-show_entries", "stream=r_frame_rate", path]
        ).decode()
        numerator, denominator = out.strip().split("/")
        return int(numerator) / int(denominator)
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return float(cap.get(cv2.CAP_PROP_FPS))
    finally:
        cap.release()


def extract_clip_frames(
    video_file: str,
    output_directory: str,
    begin_seconds: float,
    end_seconds: float,
    expected_frames: Optional[int] = None,
    extension: str = "png",
) -> int:
    """Extract [begin, end) seconds of `video_file` as numbered frames.

    :return: the number of frames written.
    """
    os.makedirs(output_directory, exist_ok=True)
    for stale in glob.glob(os.path.join(output_directory, f"*.{extension}")):
        os.remove(stale)

    if have_ffmpeg():
        pattern = os.path.join(output_directory, f"%05d.{extension}")
        subprocess.run(
            ["ffmpeg", "-v", "error", "-ss", str(begin_seconds),
             "-t", str(end_seconds - begin_seconds), "-i", video_file,
             pattern],
            check=True,
        )
        # ffmpeg numbers from 1; shift to 0-based.
        frames = sorted(glob.glob(os.path.join(output_directory, f"*.{extension}")))
        for idx, frame in enumerate(frames):
            target = os.path.join(output_directory, f"{idx:05d}.{extension}")
            if frame != target:
                shutil.move(frame, target)
        written = len(frames)
    else:
        import cv2

        cap = cv2.VideoCapture(video_file)
        try:
            fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
            begin_frame = int(round(begin_seconds * fps))
            end_frame = int(round(end_seconds * fps))
            cap.set(cv2.CAP_PROP_POS_FRAMES, begin_frame)
            written = 0
            for _ in range(begin_frame, end_frame):
                ok, frame = cap.read()
                if not ok:
                    break
                cv2.imwrite(
                    os.path.join(output_directory, f"{written:05d}.{extension}"),
                    frame,
                )
                written += 1
        finally:
            cap.release()

    if expected_frames is not None and written > expected_frames:
        for idx in range(expected_frames, written):
            os.remove(os.path.join(output_directory, f"{idx:05d}.{extension}"))
        written = expected_frames
    return written
