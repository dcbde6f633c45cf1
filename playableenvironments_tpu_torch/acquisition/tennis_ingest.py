"""Tennis video ingestion: local video + sequence annotations -> dataset
frame trees.

Copy of playableenvironments_tpu/acquisition/tennis_ingest.py (the port imports
nothing of the JAX package).

Replaces dataset/acquisition/tennis/extract_sequences_from_youtube_1.py and
extract_frames_4.py, minus the youtube-dl download step (out of scope in a
zero-egress build — any local video file works). The annotation YAML is the
reference's format (tennis_annotations/tennis_youtube_splits_annotations.
yaml): `<video>_split_NNNNN.<ext>` keys mapping to [{start, end}, ...]
segments relative to fixed-duration splits of the original video; segments
are translated to original-video times and merged when closer than half a
second (extract_sequences_from_youtube_1.py:15-90). Ingested sequences get
placeholder camera/box annotations — the `calibrate` and `boxes` pipeline
steps fill those in.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def merge_split_annotations(
    annotations: Dict[str, List[Dict[str, float]]],
    splits_duration: float,
) -> Dict[str, List[Tuple[float, float]]]:
    """Split-relative annotations -> per-original-video merged (begin, end)
    second intervals."""
    by_video: Dict[str, List[Tuple[float, float]]] = {}
    for split_name in sorted(annotations):
        marker = split_name.find("_split_")
        if marker < 0:
            original = split_name
            split_idx = 0
        else:
            extension = split_name.rsplit(".", 1)[-1]
            original = f"{split_name[:marker]}.{extension}"
            split_idx = int(split_name[marker + len("_split_"):].split(".")[0])
        segments = sorted(annotations[split_name], key=lambda s: s["start"])
        for segment in segments:
            begin = segment["start"] + split_idx * splits_duration
            end = segment["end"] + split_idx * splits_duration
            by_video.setdefault(original, []).append((begin, end))

    merged: Dict[str, List[Tuple[float, float]]] = {}
    for original, intervals in by_video.items():
        intervals.sort()
        out: List[Tuple[float, float]] = []
        for begin, end in intervals:
            # Segments straddling a split boundary reunite (< 0.5 s apart).
            if out and begin - 0.5 < out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], end))
            else:
                out.append((begin, end))
        merged[original] = out
    return merged


def ingest_tennis_video(
    video_file: str,
    sequences: Sequence[Tuple[float, float]],
    output_root: str,
    begin_index: int = 0,
    objects_count: int = 2,
) -> List[str]:
    """Extract each (begin, end) second interval of `video_file` into
    `<output_root>/<index>/00000/` as a loadable dataset video with
    placeholder camera/box annotations.

    :return: the written sequence directories.
    """
    from playableenvironments_tpu_torch.acquisition.sequence_extraction import (
        extract_clip_frames,
    )
    from playableenvironments_tpu_torch.data.video import PoseParametersNumpy, Video

    os.makedirs(output_root, exist_ok=True)
    written = []
    for sequence_idx, (begin, end) in enumerate(sequences):
        sequence_dir = os.path.join(
            output_root, f"{begin_index + sequence_idx:05d}"
        )
        camera_dir = os.path.join(sequence_dir, "00000")
        os.makedirs(camera_dir, exist_ok=True)
        frames_count = extract_clip_frames(video_file, camera_dir, begin, end)
        if frames_count == 0:
            raise RuntimeError(
                f"no frames extracted for [{begin}, {end}) of {video_file}"
            )
        identity = PoseParametersNumpy(
            rotation=[0.0, 0.0, 0.0], translation=[0.0, 0.0, 0.0]
        )
        video = Video()
        video.add_content(
            frames=[None] * frames_count,
            actions=[0] * frames_count,
            rewards=[0] * frames_count,
            metadata=[{"source": os.path.basename(video_file),
                       "begin_seconds": begin, "end_seconds": end}
                      ] + [{}] * (frames_count - 1),
            dones=[False] * frames_count,
            cameras=[identity] * frames_count,
            focals=[0.0] * frames_count,
            bounding_boxes=[np.zeros((4, objects_count), np.float32)]
            * frames_count,
            bounding_boxes_validity=[np.zeros((objects_count,), bool)]
            * frames_count,
        )
        video.save_annotations(camera_dir)
        written.append(sequence_dir)
    return written


def sequences_for_video(
    annotations_path: str,
    video_file: str,
    splits_duration: float,
    video_name: Optional[str] = None,
) -> List[Tuple[float, float]]:
    """The merged sequence intervals of `video_file` in an annotation YAML."""
    import yaml

    with open(annotations_path) as f:
        annotations = yaml.safe_load(f)
    merged = merge_split_annotations(annotations, splits_duration)
    name = video_name or os.path.basename(video_file)
    if name not in merged:
        candidates = sorted(merged)
        raise KeyError(
            f"video {name!r} not found in {annotations_path}; annotated "
            f"videos: {candidates[:10]}"
        )
    return merged[name]
