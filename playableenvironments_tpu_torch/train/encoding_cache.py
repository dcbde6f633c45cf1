"""Precomputed frozen scene encodings for phase-3 training.

Port of playableenvironments_tpu/train/encoding_cache.py. Phase 3 trains
the action module on the frozen phase-2 model's scene encodings and never
renders. The encoding is deterministic in eval mode (no style shuffle, no
perturbation), so every frame of the dataset is encoded once up front and
training reads windows of cached state vectors: image decode and the conv
encoders leave the training loop, and sequence-length annealing becomes
index arithmetic over the cache.

The cache's leaves are host numpy arrays; windows are gathered on the host
and each batch goes to the device in one copy per leaf. The npz layout
(`leaf_<field>`, `video_slices`, `skip_frames`, `fingerprint`) is the JAX
package's, so a cache written by either package loads in the other.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from playableenvironments_tpu_torch.data.batching import collate
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding


class EncodingCache:
    """Per-frame scene encodings for a dataset, windowable into batches.

    Leaves are host numpy arrays of shape (total_frames, ...): per frame the
    cameras (C, 3) x 2 and focals (C,), the object rotations and
    translations (O, 3), style and deformation (O, F) and in_scene (O).
    """

    def __init__(self, encoding: SceneEncoding, video_slices: List[Tuple[int, int]], skip_frames: int):
        """:param encoding: SceneEncoding of numpy leaves with leading axis =
            total frames (B and T axes collapsed away).
        :param video_slices: per video (start, frames_count) into that axis.
        :param skip_frames: the dataset's inter-observation frame skip.
        """
        self.encoding = encoding
        self.video_slices = video_slices
        self.skip_frames = skip_frames

    @classmethod
    def build(
        cls,
        encode_fn: Callable,
        dataset: MulticameraVideoDataset,
        batch_size: int = 32,
        log_fn=None,
    ) -> "EncodingCache":
        """Encode every frame of `dataset` once.

        :param encode_fn: data.batching.Batch (T = 1) -> SceneEncoding, e.g.
            the phase-3 trainer's `encode_batch`.
        :param dataset: the phase-3 training dataset, iterated at
            observations_count 1 so that every frame is visited exactly once;
            its observations_count is restored afterwards.
        """
        original_count = dataset.observations_count
        dataset.set_observations_count(1)
        try:
            samples = len(dataset)
            if samples == 0:
                raise ValueError("encoding cache: the dataset has no frames (empty split)")
            video_slices: List[Tuple[int, int]] = []
            start = 0
            for video in dataset.videos:
                video_slices.append((start, video.frames_count))
                start += video.frames_count
            assert start == samples, (start, samples)

            rows: List[dict] = []
            for batch_start in range(0, samples, batch_size):
                idxs = list(range(batch_start, min(batch_start + batch_size, samples)))
                pad = batch_size - len(idxs)
                batch = collate([dataset[i] for i in idxs + [idxs[-1]] * pad])
                encoded = encode_fn(batch)
                # (B, 1, ...) -> (B, ...) host rows; drop the padding.
                rows.append({k: v[: len(idxs), 0].cpu().numpy() for k, v in vars(encoded).items()})
                if log_fn is not None and (batch_start // batch_size) % 16 == 0:
                    log_fn(f"encoding cache: {min(batch_start + batch_size, samples)}/{samples} frames")
            encoding = SceneEncoding(**{k: np.concatenate([r[k] for r in rows], axis=0) for k in rows[0]})
        finally:
            dataset.set_observations_count(original_count)
        return cls(encoding, video_slices, dataset.skip_frames)

    def windows(self, observations_count: int) -> np.ndarray:
        """Global frame indexes of every valid window start (the index space
        of MulticameraVideoDataset.set_observations_count)."""
        block = (self.skip_frames + 1) * (observations_count - 1) + 1
        starts = []
        for video_start, frames_count in self.video_slices:
            usable = frames_count - block + 1
            if usable > 0:
                starts.append(video_start + np.arange(usable))
        if not starts:
            return np.zeros((0,), np.int64)
        return np.concatenate(starts)

    def gather_windows(self, starts: np.ndarray, observations_count: int) -> SceneEncoding:
        """A (bs, T, ...) encoding of numpy leaves from window start indexes."""
        step = self.skip_frames + 1
        idx = starts[:, None] + np.arange(observations_count)[None, :] * step
        return self.encoding.map(lambda leaf: leaf[idx])

    def iterate_encoding_batches(
        self,
        batch_size: int,
        observations_count: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        device="cuda",
    ) -> Iterator[SceneEncoding]:
        """One shuffled epoch of (bs, T, ...) encoding batches on `device`.

        The order is the JAX package's: the same seed gives the same global
        order on every process, and each takes its interleaved slice of an
        order cut to a multiple of process_count, so that the per-process
        batch counts agree.
        """
        order = self.windows(observations_count)
        if shuffle:
            order = order.copy()
            np.random.default_rng(seed).shuffle(order)
        if process_count > 1:
            usable = (len(order) // process_count) * process_count
            order = order[:usable][process_index::process_count]
        n_batches = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
        for b in range(n_batches):
            starts = order[b * batch_size : (b + 1) * batch_size]
            yield self.gather_windows(starts, observations_count).map(lambda x: torch.from_numpy(x).to(device))

    def save(self, path: str, fingerprint: float = 0.0):
        """npz snapshot.

        :param fingerprint: identifies the frozen environment weights that
            produced the cache (`params_fingerprint`); `load` compares it to
            reject a stale cache.
        """
        np.savez_compressed(
            path,
            video_slices=np.asarray(self.video_slices, np.int64),
            skip_frames=np.int64(self.skip_frames),
            fingerprint=np.float64(fingerprint),
            **{f"leaf_{name}": np.asarray(leaf) for name, leaf in vars(self.encoding).items()},
        )

    @classmethod
    def load(cls, path: str, fingerprint: Optional[float] = None) -> "EncodingCache":
        """:param fingerprint: when given, raises ValueError if the stored
        fingerprint differs (a cache built from other weights)."""
        data = np.load(path)
        stored = float(data["fingerprint"]) if "fingerprint" in data.files else 0.0
        if fingerprint is not None and not np.isclose(stored, fingerprint, rtol=1e-6, atol=1e-8):
            raise ValueError(
                f"encoding cache at {path} was built from different frozen env weights "
                f"(fingerprint {stored} != {fingerprint}); rebuild it"
            )
        leaves = {name[len("leaf_"):]: data[name] for name in data.files if name.startswith("leaf_")}
        return cls(
            SceneEncoding(**leaves),
            [tuple(int(v) for v in row) for row in data["video_slices"]],
            int(data["skip_frames"]),
        )


def params_fingerprint(*modules: torch.nn.Module) -> float:
    """A cheap deterministic scalar fingerprint of the modules' parameters
    (buffers excluded): the JAX package's, the sum over leaves of
    sum |x| mod 1e9 in float64, taken over the parameters that a flax
    params tree holds. Layouts (a transposed kernel) do not change it."""
    total = 0.0
    for module in modules:
        for _, p in module.named_parameters():
            total += float(p.detach().abs().double().sum().item()) % 1e9
    return total % 1e9
