"""Dataset splitting and fixed-length fragmenting.

Copy of playableenvironments_tpu/acquisition/splits.py (the port imports
nothing of the JAX package).

Replaces dataset/acquisition/{utils/video_fragmenter.py,
tennis/make_train_val_test_split_6.py, minecraft/train_val_test_split.py,
*/make_fixed_length*.py}: split a flat directory of multicamera videos into
train/val/test subdirectories, and cut videos into fixed-length fragments so
every sample window is full-length.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Sequence, Tuple

from playableenvironments_tpu_torch.data.video import MulticameraVideo, Video


def list_video_dirs(root: str) -> List[str]:
    return sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )


def split_dataset(
    root: str,
    output_root: str,
    fractions: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    move: bool = False,
) -> Dict[str, List[str]]:
    """Deterministically split videos into train/val/test by index order
    (the reference splits by explicit annotation lists; index split is the
    fallback it uses for minecraft, train_val_test_split.py).

    :return: {"train": [...], "val": [...], "test": [...]} video dir names.
    """
    assert abs(sum(fractions) - 1.0) < 1e-6
    videos = list_video_dirs(root)
    n = len(videos)
    n_train = int(round(fractions[0] * n))
    n_val = int(round(fractions[1] * n))
    assignment = {
        "train": videos[:n_train],
        "val": videos[n_train : n_train + n_val],
        "test": videos[n_train + n_val :],
    }
    transfer = shutil.move if move else shutil.copytree
    for split, names in assignment.items():
        split_dir = os.path.join(output_root, split)
        os.makedirs(split_dir, exist_ok=True)
        for new_idx, name in enumerate(names):
            dst = os.path.join(split_dir, f"{new_idx:05d}")
            if os.path.exists(dst):
                shutil.rmtree(dst)
            transfer(os.path.join(root, name), dst)
    return assignment


def fragment_video(
    video_dir: str, output_root: str, fragment_length: int, begin_index: int
) -> int:
    """Cut one multicamera video into consecutive `fragment_length`-frame
    videos (video_fragmenter.py); the tail shorter than a fragment is
    dropped. Returns the next free output index."""
    video = MulticameraVideo().load(video_dir)
    frames = video.frames_count
    fragments = frames // fragment_length
    index = begin_index
    for frag in range(fragments):
        begin = frag * fragment_length
        out_dir = os.path.join(output_root, f"{index:05d}")
        for camera_idx, camera in enumerate(video.videos):
            camera_out = os.path.join(out_dir, f"{camera_idx:05d}")
            os.makedirs(camera_out, exist_ok=True)
            sliced = _slice_video(camera, begin, begin + fragment_length)
            sliced.save(camera_out, exists_ok=True)
        index += 1
    return index


def _slice_video(video: Video, begin: int, end: int) -> Video:
    out = Video()
    out.add_content(
        frames=[video.get_frame(i) for i in range(begin, end)],
        actions=video.actions[begin:end],
        rewards=video.rewards[begin:end],
        metadata=video.metadata[begin:end],
        dones=video.dones[begin:end],
        cameras=video.cameras[begin:end],
        focals=video.focals[begin:end],
        bounding_boxes=video.bounding_boxes[begin:end],
        bounding_boxes_validity=video.bounding_boxes_validity[begin:end],
        **{
            # Per-frame optionals are sliced; whole-video ones (crop_region)
            # pass through unchanged.
            key: (
                value[begin:end]
                if hasattr(value, "__len__") and len(value) == video.frames_count
                else value
            )
            for key, value in (
                (k, getattr(video, k)) for k in Video.OPTIONAL_PICKLE_FILES
            )
            if value is not None
        },
    )
    return out


def make_fixed_length(
    root: str, output_root: str, fragment_length: int
) -> int:
    """Fragment every video under `root` (make_fixed_length.py /
    make_fixed_length_8.py). Returns the number of fragments written."""
    os.makedirs(output_root, exist_ok=True)
    index = 0
    for name in list_video_dirs(root):
        index = fragment_video(
            os.path.join(root, name), output_root, fragment_length, index
        )
    return index
