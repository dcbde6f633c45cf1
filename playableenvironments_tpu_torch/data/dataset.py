"""Windowed sampling over a directory of multicamera videos.

Copy of playableenvironments_tpu/data/dataset.py (the port imports nothing
of the JAX package); its batches are data.batching.Batch of CPU tensors.
Replaces the reference's dataset/video_dataset.py: a sample is `observations_count` frames
spaced `skip_frames` apart, each a stack of `observation_stacking` past frames
(video_dataset.py:141-196). `set_observations_count` re-derives the index
space at runtime for phase-3 sequence-length annealing (58-71).

The loader is host-side Python (decode + stack into numpy); `iterate_batches`
provides shuffled epochs with a background prefetch thread, in place of
the reference's DataLoader workers.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from playableenvironments_tpu_torch.data.batching import Batch, collate
from playableenvironments_tpu_torch.data.video import MulticameraVideo


class MulticameraVideoDataset:
    def __init__(
        self,
        path: str,
        observations_count: int,
        skip_frames: int = 0,
        observation_stacking: int = 1,
        allowed_cameras: Optional[Sequence[int]] = None,
        target_size: Optional[tuple] = None,
    ):
        """:param path: directory of multicamera video directories.
        :param observations_count: frames per sample (T).
        :param skip_frames: frames skipped between observations.
        :param observation_stacking: past frames stacked per observation (K).
        :param allowed_cameras: camera indices to expose (default: all).
        :param target_size: optional (height, width) resize.
        """
        self.path = path
        video_dirs = sorted(
            d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d))
        )
        if not video_dirs:
            raise FileNotFoundError(f"no videos found under {path}")
        self.videos = [
            MulticameraVideo().load(os.path.join(path, d)) for d in video_dirs
        ]
        self.skip_frames = skip_frames
        self.observation_stacking = observation_stacking
        self.allowed_cameras = (
            list(allowed_cameras)
            if allowed_cameras is not None
            else list(range(self.videos[0].cameras_count))
        )
        self.target_size = target_size
        self.set_observations_count(observations_count)

    def set_observations_count(
        self, observations_count: int, window_stride: int = 1
    ):
        """Re-derive the sample index space (video_dataset.py:58-71); used by
        phase-3 sequence-length annealing mid-training.

        :param window_stride: spacing between window starts. 1 (default) =
            every offset, as in reference training; pass the window length
            for NON-overlapping windows — the dataset creators need this so
            later windows don't overwrite earlier windows' rendered frames
            (the reference sidesteps it by pre-fragmenting eval videos to
            exactly one window each).
        """
        self.observations_count = observations_count
        block = (self.skip_frames + 1) * (observations_count - 1) + 1
        self._index = []
        # Dataset-global frame numbering (video offsets): per-frame learned
        # camera offsets are indexed by these, so frame k of video 0 and
        # frame k of video 1 must NOT alias to the same storage row.
        self._video_frame_offsets = []
        offset = 0
        for video in self.videos:
            self._video_frame_offsets.append(offset)
            offset += video.frames_count
        self.total_frames = offset
        for video_idx, video in enumerate(self.videos):
            usable = video.frames_count - block + 1
            for start in range(0, max(usable, 0), max(window_stride, 1)):
                self._index.append((video_idx, start))

    def __len__(self) -> int:
        return len(self._index)

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        if self.target_size is None:
            return frame
        h, w = self.target_size
        if frame.shape[:2] == (h, w):
            return frame
        from PIL import Image

        img = Image.fromarray((frame * 255).astype(np.uint8))
        return np.asarray(img.resize((w, h), Image.BILINEAR), np.float32) / 255.0

    def _decode_frames_native(self, video, frame_indexes) -> Optional[dict]:
        """Batch-decode every frame this sample touches through the native
        C++ loader (decode + resize + normalize in one threaded call).
        Returns {(camera_idx, frame_idx): (H, W, 3) float32} or None when
        the native path does not apply (no library / in-memory frames)."""
        from playableenvironments_tpu_torch.data import native_loader

        if not native_loader.available():
            return None
        wanted = []
        for frame_idx in frame_indexes:
            for camera_idx in self.allowed_cameras:
                for s in range(self.observation_stacking):
                    wanted.append((camera_idx, max(frame_idx - s, 0)))
        wanted = sorted(set(wanted))
        paths = []
        for camera_idx, src in wanted:
            path = video.videos[camera_idx].get_frame_path(src)
            if path is None or not path.lower().endswith(".png"):
                return None
            paths.append(path)
        size = self.target_size or video.image_size()
        try:
            frames = native_loader.decode_batch(paths, tuple(size))
        except (IOError, RuntimeError):
            return None
        return {key: frames[i] for i, key in enumerate(wanted)}

    def __getitem__(self, idx: int) -> dict:
        video_idx, start = self._index[idx]
        video = self.videos[video_idx]
        step = self.skip_frames + 1
        frame_indexes = [start + i * step for i in range(self.observations_count)]
        decoded = self._decode_frames_native(video, frame_indexes)

        observations, rotations, translations, focals = [], [], [], []
        boxes, validity = [], []
        for frame_idx in frame_indexes:
            per_camera_obs, per_camera_rot, per_camera_trans = [], [], []
            per_camera_focal, per_camera_box, per_camera_valid = [], [], []
            for camera_idx in self.allowed_cameras:
                cam_video = video.videos[camera_idx]
                # Stack the current frame with observation_stacking - 1 past
                # frames along channels, most recent first
                # (video_dataset.py:141-160).
                stack = []
                for s in range(self.observation_stacking):
                    src = max(frame_idx - s, 0)
                    if decoded is not None:
                        stack.append(decoded[(camera_idx, src)])
                    else:
                        stack.append(self._resize(cam_video.get_frame(src)))
                per_camera_obs.append(np.concatenate(stack, axis=-1))
                pose = cam_video.cameras[frame_idx]
                per_camera_rot.append(np.asarray(pose.rotation, np.float32))
                per_camera_trans.append(np.asarray(pose.translation, np.float32))
                per_camera_focal.append(np.float32(cam_video.focals[frame_idx]))
                # Disk layout is (4, O); in-memory convention is (O, 4).
                per_camera_box.append(
                    np.asarray(cam_video.bounding_boxes[frame_idx], np.float32).T
                )
                per_camera_valid.append(
                    np.asarray(
                        cam_video.bounding_boxes_validity[frame_idx], bool
                    )
                )
            observations.append(np.stack(per_camera_obs))
            rotations.append(np.stack(per_camera_rot))
            translations.append(np.stack(per_camera_trans))
            focals.append(np.stack(per_camera_focal))
            boxes.append(np.stack(per_camera_box))
            validity.append(np.stack(per_camera_valid))

        # Optional annotations: keypoints and optical flow (present only when
        # the videos carry them; the consistency losses consume these).
        optional = {}
        first_cam = video.videos[self.allowed_cameras[0]]
        if first_cam.keypoints is not None:
            kp = np.stack(
                [
                    np.stack(
                        [
                            np.asarray(
                                video.videos[c].keypoints[i], np.float32
                            )
                            for c in self.allowed_cameras
                        ]
                    )
                    for i in frame_indexes
                ]
            )
            optional["keypoints"] = kp
            if first_cam.keypoints_validity is not None:
                optional["keypoints_validity"] = np.stack(
                    [
                        np.stack(
                            [
                                np.asarray(
                                    video.videos[c].keypoints_validity[i], bool
                                )
                                for c in self.allowed_cameras
                            ]
                        )
                        for i in frame_indexes
                    ]
                )
        if first_cam.has_flow:
            flows = []
            for i in frame_indexes:
                per_camera = []
                for c in self.allowed_cameras:
                    flow = video.videos[c].get_flow(i)
                    if flow is None:
                        h, w = self.target_size or video.image_size()
                        flow = np.zeros((h, w, 2), np.float32)
                    per_camera.append(flow)
                flows.append(np.stack(per_camera))
            optional["optical_flow"] = np.stack(flows)

        return {
            **optional,
            "observations": np.stack(observations),
            "camera_rotations": np.stack(rotations),
            "camera_translations": np.stack(translations),
            "focals": np.stack(focals),
            "bounding_boxes": np.stack(boxes),
            "bounding_boxes_validity": np.stack(validity),
            "global_frame_indexes": np.asarray(
                [self._video_frame_offsets[video_idx] + i for i in frame_indexes],
                np.int32,
            ),
            "video_frame_indexes": np.asarray(frame_indexes, np.int32),
            "video_index": video_idx,
            "actions": np.asarray(
                [video.videos[self.allowed_cameras[0]].actions[i] for i in frame_indexes],
                np.int32,
            ),
        }

    def iterate_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        start: int = 0,
    ) -> Iterator[Batch]:
        """One shuffled epoch of fixed-size batches with background prefetch,
        from its batch `start` on (the batches before it are not loaded).

        Multi-host: every process generates the SAME global order (same seed)
        and takes its interleaved slice, so per-host batches assemble into a
        consistent global batch."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if process_count > 1:
            # Truncate to a multiple of process_count first: otherwise hosts
            # get slices whose lengths differ by 1 and (with drop_last) can
            # yield different batch counts, hanging the collective train step
            # mid-epoch on the shorter host.
            usable = (len(order) // process_count) * process_count
            order = order[:usable][process_index::process_count]
        n_batches = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
        if n_batches == 0:
            return

        # The consumer may abandon the generator early (`next(...)` once,
        # `break` after N batches — most call sites do); `stop` unblocks the
        # producer so it exits instead of leaking a thread pinning ~prefetch
        # collated video batches forever.
        stop = threading.Event()

        def producer(q):
            for b in range(start, n_batches):
                if stop.is_set():
                    return
                idxs = order[b * batch_size : (b + 1) * batch_size]
                item = collate([self[int(i)] for i in idxs])
                while True:
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        if stop.is_set():
                            return
            # The end-of-epoch sentinel needs the same timed-put loop: a
            # plain blocking put leaks the thread when the producer finishes
            # all batches (queue full) before the consumer abandons us.
            while True:
                try:
                    q.put(None, timeout=0.5)
                    return
                except queue.Full:
                    if stop.is_set():
                        return

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        thread = threading.Thread(target=producer, args=(q,), daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
