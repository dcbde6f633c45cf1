"""On-disk video format, byte-compatible with the reference datasets.

Copy of playableenvironments_tpu/data/video.py (the port imports nothing of
the JAX package). A Video directory holds frames `00000.png, 00001.png, ...`
plus pickled per-frame metadata lists (actions/rewards/metadata/dones/
cameras/focals/bounding_boxes/bounding_box_validity, optional keypoints/
object_poses/crop_region). A MulticameraVideo is a directory of per-camera
Video subdirectories `00000, 00001, ...`.

Reference pickles contain `utils.lib_3d.pose_parameters.PoseParametersNumpy`
instances; `_CompatUnpickler` maps that class path onto this module's shim,
and the shim spoofs its `__module__` when saving so that datasets written
here load in the reference, and in the JAX package, unchanged. When both
packages are imported, the one that pickles first registers its shim at
that module path and the other's `_CompatPickler` writes through it, so the
bytes name the same class path either way.

PNGs go through the native C++ codec (data/native_loader.py) when its
library loads, else through Pillow; `png_codec()` names the one in use.
"""

from __future__ import annotations

import io
import os
import pickle
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FRAME_NAME_DIGITS = 5


class PoseParametersNumpy:
    """Euler rotation + translation pose, pickle-compatible with the
    reference's PoseParametersNumpy (pose_parameters.py:109-138)."""

    def __init__(self, rotation: Sequence, translation: Sequence):
        self.rotation = np.asarray(rotation, dtype=np.float32)
        self.translation = np.asarray(translation, dtype=np.float32)


# Pickle under the reference's module path so reference code can unpickle.
PoseParametersNumpy.__module__ = "utils.lib_3d.pose_parameters"


def _register_compat_modules():
    """Install stub modules at the reference's pickle paths so pickling our
    shim classes (and plain unpickling of reference files) succeeds without
    the reference on sys.path."""
    import sys
    import types

    if "utils.lib_3d.pose_parameters" in sys.modules:
        return
    utils_mod = sys.modules.setdefault("utils", types.ModuleType("utils"))
    # Cooperate with an importable reference checkout (tests import both):
    # reuse a real utils.lib_3d package instead of shadowing it, so its other
    # submodules (transformations_3d, ...) stay importable.
    lib3d_mod = sys.modules.get("utils.lib_3d")
    if lib3d_mod is None:
        lib3d_mod = types.ModuleType("utils.lib_3d")
        sys.modules["utils.lib_3d"] = lib3d_mod
        utils_mod.lib_3d = lib3d_mod
    pose_mod = types.ModuleType("utils.lib_3d.pose_parameters")
    pose_mod.PoseParametersNumpy = PoseParametersNumpy
    pose_mod.PoseParameters = PoseParametersNumpy
    lib3d_mod.pose_parameters = pose_mod
    sys.modules["utils.lib_3d.pose_parameters"] = pose_mod


_COMPAT_CLASSES = {
    ("utils.lib_3d.pose_parameters", "PoseParametersNumpy"): PoseParametersNumpy,
    ("utils.lib_3d.pose_parameters", "PoseParameters"): PoseParametersNumpy,
}


class _CompatUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _COMPAT_CLASSES:
            return _COMPAT_CLASSES[(module, name)]
        return super().find_class(module, name)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return _CompatUnpickler(f).load()


class _CompatPickler(pickle.Pickler):
    """When the REAL reference checkout is on sys.path and imported, the
    genuine utils.lib_3d.pose_parameters module occupies the pickle path and
    our shim class is "not the same object" under pickle's save-global
    identity check. Re-target shim instances to the loaded reference class
    (same constructor signature, pose_parameters.py:115-130) so the written
    bytes keep the reference module path either way."""

    def reducer_override(self, obj):
        if type(obj) is PoseParametersNumpy:
            real = sys.modules.get("utils.lib_3d.pose_parameters")
            target = getattr(real, "PoseParametersNumpy", PoseParametersNumpy)
            if target is not PoseParametersNumpy:
                return (target, (obj.rotation, obj.translation))
        return NotImplemented


def _save_pickle(obj, path: str):
    # Install the reference-path module shims lazily: pickle looks classes up
    # by module path at DUMP time, and installing at import time would shadow
    # an importable reference checkout (tests import both).
    _register_compat_modules()
    with open(path, "wb") as f:
        _CompatPickler(f).dump(obj)


def _frame_name(idx: int) -> str:
    return f"{idx:0{FRAME_NAME_DIGITS}}"


def png_codec() -> str:
    """The PNG codec that frames are read and written with here: the native
    loader (libpng) when its library loads, else Pillow. Raises when
    neither is available."""
    from playableenvironments_tpu_torch.data import native_loader

    if native_loader.available():
        return "native libpe_dataloader (libpng)"
    try:
        import PIL
    except ImportError as error:
        raise RuntimeError("no PNG codec: the native loader does not load and Pillow is missing") from error
    return f"Pillow {PIL.__version__}"


def _load_image(path: str) -> np.ndarray:
    """Load an image file to (H, W, 3) float32 in [0, 1].

    PNGs decode through the native C++ loader (libpng, no GIL) when the
    shared library is available; anything else (and the fallback) uses PIL.
    """
    if path.lower().endswith(".png"):
        from playableenvironments_tpu_torch.data import native_loader

        if native_loader.available():
            try:
                return native_loader.decode(path)
            except IOError:
                pass  # fall through to PIL on malformed files
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def _resize_image(array: np.ndarray, target_size: Tuple[int, int]) -> np.ndarray:
    """Bicubic resize of a (H, W, 3) float [0, 1] frame to (height, width)."""
    from PIL import Image

    img = Image.fromarray(
        np.clip(np.asarray(array) * 255.0, 0, 255).astype(np.uint8)
    )
    resized = img.resize((target_size[1], target_size[0]), Image.BICUBIC)
    return np.asarray(resized, dtype=np.float32) / 255.0


def _save_image(array: np.ndarray, path: str):
    if path.lower().endswith(".png"):
        from playableenvironments_tpu_torch.data import native_loader

        if native_loader.available():
            try:
                native_loader.encode(path, np.asarray(array, np.float32))
                return
            except IOError:
                pass  # fall through to PIL
    from PIL import Image

    img = Image.fromarray(
        np.clip(np.asarray(array) * 255.0, 0, 255).astype(np.uint8)
    )
    img.save(path)


class Video:
    """A single-camera video with per-frame annotations, loaded lazily.

    Attribute layout mirrors the reference (dataset/video.py):
      - cameras: list of PoseParametersNumpy (camera-to-world pose)
      - focals: list of floats (pixels)
      - bounding_boxes: list of (4, dynamic_objects) float arrays, normalized
        (l, t, r, b) in [0, 1]
      - bounding_boxes_validity: list of (dynamic_objects,) bool arrays
    """

    PICKLE_FILES = {
        "actions": "actions.pkl",
        "rewards": "rewards.pkl",
        "metadata": "metadata.pkl",
        "dones": "dones.pkl",
        "cameras": "cameras.pkl",
        "focals": "focals.pkl",
        "bounding_boxes": "bounding_boxes.pkl",
        "bounding_boxes_validity": "bounding_box_validity.pkl",
    }
    OPTIONAL_PICKLE_FILES = {
        "keypoints": "keypoints.pkl",
        "keypoints_validity": "keypoints_validity.pkl",
        "object_poses": "object_poses.pkl",
        "crop_region": "crop_region.pkl",
    }

    def __init__(self):
        self.path: Optional[str] = None
        self.frame_paths: List[str] = []
        self._frames_in_memory: Optional[List[np.ndarray]] = None
        self.actions: List[int] = []
        self.rewards: List[float] = []
        self.metadata: List[Dict] = []
        self.dones: List[bool] = []
        self.cameras: List[PoseParametersNumpy] = []
        self.focals: List[float] = []
        self.bounding_boxes: List[np.ndarray] = []
        self.bounding_boxes_validity: List[np.ndarray] = []
        self.keypoints = None
        self.keypoints_validity = None
        self.object_poses = None
        self.crop_region = None

    # ------------------------------------------------------------------

    def add_content(
        self,
        frames: List[np.ndarray],
        actions: List[int],
        rewards: List[float],
        metadata: List[Dict],
        dones: List[bool],
        cameras: List[PoseParametersNumpy],
        focals: List[float],
        bounding_boxes: List[np.ndarray],
        bounding_boxes_validity: List[np.ndarray],
        **optional,
    ) -> "Video":
        """Populate in memory (the dataset-construction API,
        dataset/video.py:64-137). Frames are (H, W, 3) float arrays in [0, 1]."""
        n = len(frames)
        for name, seq in [
            ("actions", actions), ("rewards", rewards), ("metadata", metadata),
            ("dones", dones), ("cameras", cameras), ("focals", focals),
            ("bounding_boxes", bounding_boxes),
            ("bounding_boxes_validity", bounding_boxes_validity),
        ]:
            if len(seq) != n:
                raise ValueError(f"{name} has {len(seq)} entries for {n} frames")
        self._frames_in_memory = [
            None if f is None else np.asarray(f, dtype=np.float32)
            for f in frames
        ]
        self.frame_paths = [None] * n
        self.actions = list(actions)
        self.rewards = list(rewards)
        self.metadata = list(metadata)
        self.dones = list(dones)
        self.cameras = list(cameras)
        self.focals = list(focals)
        self.bounding_boxes = [np.asarray(b, np.float32) for b in bounding_boxes]
        self.bounding_boxes_validity = [
            np.asarray(v, bool) for v in bounding_boxes_validity
        ]
        for key in self.OPTIONAL_PICKLE_FILES:
            if key in optional:
                setattr(self, key, optional[key])
        return self

    def load(self, path: str) -> "Video":
        if not os.path.isdir(path):
            raise FileNotFoundError(f"not a video directory: {path}")
        self.path = path
        names = sorted(
            f for f in os.listdir(path)
            if f.endswith((".png", ".jpg", ".jpeg")) and f.split(".")[0].isdigit()
        )
        self.frame_paths = [os.path.join(path, f) for f in names]
        n = len(self.frame_paths)

        defaults = {
            "actions": lambda: [0] * n,
            "rewards": lambda: [0.0] * n,
            "metadata": lambda: [{} for _ in range(n)],
            "dones": lambda: [False] * n,
            "cameras": lambda: [
                PoseParametersNumpy([0.0] * 3, [0.0] * 3) for _ in range(n)
            ],
            "focals": lambda: [1.0] * n,
            "bounding_boxes": lambda: [
                np.zeros((4, 0), np.float32) for _ in range(n)
            ],
            "bounding_boxes_validity": lambda: [
                np.zeros((0,), bool) for _ in range(n)
            ],
        }
        for attr, filename in self.PICKLE_FILES.items():
            file_path = os.path.join(path, filename)
            if os.path.isfile(file_path):
                setattr(self, attr, _load_pickle(file_path))
            else:
                setattr(self, attr, defaults[attr]())
        for attr, filename in self.OPTIONAL_PICKLE_FILES.items():
            file_path = os.path.join(path, filename)
            if os.path.isfile(file_path):
                setattr(self, attr, _load_pickle(file_path))
        return self

    def subsample_split_resize(
        self,
        frame_skip: int,
        output_sequence_length: int,
        crop_size: Optional[Tuple[int, int, int, int]] = None,
        target_size: Optional[Tuple[int, int]] = None,
        min_sequence_length: Optional[int] = None,
    ) -> List["Video"]:
        """Temporal subsample + fixed-length split + optional crop/resize
        (the dataset-preparation op, dataset/video.py:625-733). Optical flow
        is not carried over.

        CAVEAT (matches the reference exactly, same lines): annotations are
        copied UNREMAPPED — `crop_size` shifts what normalized bounding
        boxes refer to, and resizing changes the pixels-per-unit scale while
        `focals` stay in original pixels. The published pipelines only crop
        before annotating and absorb resize via `focal_length_multiplier`;
        do the same, or remap boxes/focals yourself when cropping annotated
        videos.

        :param frame_skip: source frames skipped between kept frames.
        :param output_sequence_length: frames per output video (-1 keeps all).
        :param crop_size: (left, top, right, bottom) pixel crop before resize.
        :param target_size: (height, width) output frame size.
        :return: list of Videos.
        """
        step = frame_skip + 1
        indexes = list(range(0, self.frames_count, step))

        def prepare(idx: int) -> np.ndarray:
            frame = self.get_frame(idx)
            if crop_size is not None:
                left, top, right, bottom = crop_size
                frame = frame[top:bottom, left:right]
            if target_size is not None and frame.shape[:2] != tuple(target_size):
                from PIL import Image

                img = Image.fromarray((frame * 255).astype(np.uint8))
                frame = (
                    np.asarray(
                        img.resize((target_size[1], target_size[0]), Image.BICUBIC),
                        np.float32,
                    )
                    / 255.0
                )
            return frame

        length = (
            len(indexes) if output_sequence_length == -1 else output_sequence_length
        )
        minimum = min_sequence_length if min_sequence_length is not None else length
        videos = []
        for begin in range(0, len(indexes), length):
            chunk = indexes[begin : begin + length]
            if len(chunk) < minimum:
                continue
            video = Video()
            optional = {}
            for key in self.OPTIONAL_PICKLE_FILES:
                value = getattr(self, key)
                if value is not None and hasattr(value, "__len__") and len(
                    value
                ) == self.frames_count:
                    optional[key] = [value[i] for i in chunk]
            video.add_content(
                frames=[prepare(i) for i in chunk],
                actions=[self.actions[i] for i in chunk],
                rewards=[self.rewards[i] for i in chunk],
                metadata=[self.metadata[i] for i in chunk],
                dones=[self.dones[i] for i in chunk],
                cameras=[self.cameras[i] for i in chunk],
                focals=[self.focals[i] for i in chunk],
                bounding_boxes=[self.bounding_boxes[i] for i in chunk],
                bounding_boxes_validity=[
                    self.bounding_boxes_validity[i] for i in chunk
                ],
                **optional,
            )
            videos.append(video)
        return videos

    def save(self, path: str, exists_ok: bool = False):
        """Write the reference on-disk layout (dataset/video.py:765-815)."""
        os.makedirs(path, exist_ok=exists_ok)
        for idx in range(self.frames_count):
            if (
                self.frame_paths[idx] is None
                and self._frames_in_memory[idx] is None
            ):
                # Annotation-only video (acquisition writes frames through a
                # separate ffmpeg/cv2 extraction step); the PNG may already
                # be on disk at the destination.
                continue
            _save_image(
                self.get_frame(idx), os.path.join(path, _frame_name(idx) + ".png")
            )
        self.save_annotations(path)

    def save_moco(
        self,
        path: str,
        extension: str = "png",
        target_size: Optional[Tuple[int, int]] = None,
    ):
        """Export to the MoCoGAN strip format: every frame concatenated
        horizontally into one `{path}.{extension}` image
        (dataset/video.py:733-763). `target_size` is (width, height).
        """
        if os.path.exists(f"{path}.{extension}"):
            raise FileExistsError(f"'{path}.{extension}' already exists")
        frames = [self.get_frame(idx) for idx in range(self.frames_count)]
        if target_size is not None:
            width, height = target_size
            frames = [_resize_image(frame, (height, width)) for frame in frames]
        max_height = max(frame.shape[0] for frame in frames)
        frames = [
            np.pad(frame, ((0, max_height - frame.shape[0]), (0, 0), (0, 0)))
            for frame in frames
        ]
        strip = np.concatenate(frames, axis=1)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        _save_image(strip, f"{path}.{extension}")

    def save_annotations(self, path: str):
        """Write only the pickled annotation files (no frame PNGs)."""
        os.makedirs(path, exist_ok=True)
        for attr, filename in self.PICKLE_FILES.items():
            _save_pickle(getattr(self, attr), os.path.join(path, filename))
        for attr, filename in self.OPTIONAL_PICKLE_FILES.items():
            value = getattr(self, attr)
            if value is not None:
                _save_pickle(value, os.path.join(path, filename))

    # ------------------------------------------------------------------

    @property
    def frames_count(self) -> int:
        return len(self.frame_paths)

    @property
    def dynamic_objects_count(self) -> int:
        if not self.bounding_boxes:
            return 0
        return int(np.asarray(self.bounding_boxes[0]).shape[-1])

    def get_frame(self, idx: int) -> np.ndarray:
        """(H, W, 3) float32 in [0, 1]."""
        if self._frames_in_memory is not None:
            return self._frames_in_memory[idx]
        return _load_image(self.frame_paths[idx])

    def get_frame_path(self, idx: int) -> Optional[str]:
        return self.frame_paths[idx]

    def image_size(self) -> Tuple[int, int]:
        """(height, width) of the frames. Cached — this sits on the hot
        data-loading path (one call per __getitem__ when target_size is
        unset); the native PNG header read avoids a full frame decode."""
        if self._frames_in_memory is not None:
            return tuple(self._frames_in_memory[0].shape[:2])
        cached = getattr(self, "_image_size", None)
        if cached is not None:
            return cached
        size = None
        path = self.frame_paths[0] if self.frame_paths else None
        if path and path.lower().endswith(".png"):
            from playableenvironments_tpu_torch.data import native_loader

            if native_loader.available():
                try:
                    size = tuple(native_loader.png_size(path))
                except (IOError, RuntimeError):
                    size = None
        if size is None:
            size = tuple(self.get_frame(0).shape[:2])
        self._image_size = size
        return size

    @property
    def has_flow(self) -> bool:
        return self.path is not None and os.path.isdir(
            os.path.join(self.path, "flow")
        )

    def get_flow(self, idx: int) -> Optional[np.ndarray]:
        """Optical flow frame->frame+1 as (H, W, 2) normalized (d_row, d_col),
        from flow/<frame>.npy (or the reference's per-object layout
        flow/<object>/<frame>.npy, first object; dataset/video.py:24-39)."""
        if self.path is None:
            return None
        flow_dir = os.path.join(self.path, "flow")
        candidates = [os.path.join(flow_dir, _frame_name(idx) + ".npy")]
        if os.path.isdir(flow_dir):
            for sub in sorted(os.listdir(flow_dir)):
                candidates.append(
                    os.path.join(flow_dir, sub, _frame_name(idx) + ".npy")
                )
        for path in candidates:
            if os.path.isfile(path):
                flow = np.load(path).astype(np.float32)
                if flow.shape[0] == 2 and flow.ndim == 3:  # (2, H, W) layout
                    flow = np.moveaxis(flow, 0, -1)
                return flow
        return None


class MulticameraVideo:
    """A directory of per-camera Videos with aligned frame indices.
    Reference: dataset/multicamera_video.py."""

    def __init__(self, videos: Optional[List[Video]] = None):
        self.videos: List[Video] = videos or []

    def load(self, path: str) -> "MulticameraVideo":
        if not os.path.isdir(path):
            raise FileNotFoundError(f"not a multicamera video directory: {path}")
        camera_dirs = sorted(
            d for d in os.listdir(path)
            if os.path.isdir(os.path.join(path, d)) and d.isdigit()
        )
        if not camera_dirs:
            raise FileNotFoundError(f"no camera subdirectories in {path}")
        self.videos = [Video().load(os.path.join(path, d)) for d in camera_dirs]
        counts = {v.frames_count for v in self.videos}
        if len(counts) != 1:
            raise ValueError(f"cameras disagree on frame count: {counts}")
        return self

    def save(self, path: str, exists_ok: bool = False):
        os.makedirs(path, exist_ok=exists_ok)
        for idx, video in enumerate(self.videos):
            video.save(os.path.join(path, _frame_name(idx)), exists_ok=exists_ok)

    @property
    def cameras_count(self) -> int:
        return len(self.videos)

    @property
    def frames_count(self) -> int:
        return self.videos[0].frames_count

    @property
    def dynamic_objects_count(self) -> int:
        return self.videos[0].dynamic_objects_count

    def image_size(self) -> Tuple[int, int]:
        return self.videos[0].image_size()
