"""Dataset evaluators: paired metrics over reference/generated dataset trees,
and action-space diagnostics for playability datasets.

Port of playableenvironments_tpu/eval/evaluators.py:
`ReconstructedDatasetEvaluator` (per-frame MSE, PSNR, SSIM and VGG cosine
similarity, motion-masked MSE over windows, FID),
`ReconstructedPlayabilityDatasetEvaluator` (adds FVD over camera 0's
clips, folded into the decode loop, and the action-space diagnostics from
the annotations and the inferred actions, with their plots),
`ReconstructedDatasetFVDEvaluator` and `save_results_yaml`. The results
carry the JAX package's keys. LPIPS and the detection metrics wait for
their networks (ROADMAP queue A).

The metric networks (VGG19 features, the FID/FVD embedders) run on the
evaluator's device, `EMBED_CHUNK` frames a forward pass, so that a whole
camera of a real test video fits the card; so do the image metrics. The
VGG features run on seeded random weights, and the key says so
(`vgg_cosine_similarity_selfconsistent`). An evaluator given `times`
(cli.common.RunTimes) splits its seconds into `decode` (reading the PNGs),
`metrics` (the image metrics and statistics) and `networks` (VGG and the
embedders).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.eval import metrics as metrics_lib
from playableenvironments_tpu_torch.eval.distribution_metrics import (
    EMBED_CHUNK,
    IncrementalFID,
    IncrementalFVD,
)
from playableenvironments_tpu_torch.eval.perceptual import VGGFeatures, init_vgg19, vgg_cosine_similarity
from playableenvironments_tpu_torch.utils.device import resolve_device

def box_centers_from_annotations(video, camera_idx: int, frame_idx: int) -> np.ndarray:
    """Normalized (row, col) centers of the annotated boxes of one frame."""
    cam = video.videos[camera_idx]
    boxes = np.asarray(cam.bounding_boxes[frame_idx], np.float32).T  # (O, 4)
    validity = np.asarray(cam.bounding_boxes_validity[frame_idx], bool)
    boxes = boxes[validity]
    if not len(boxes):
        return np.zeros((0, 2), np.float32)
    return np.stack([(boxes[:, 1] + boxes[:, 3]) / 2.0, (boxes[:, 0] + boxes[:, 2]) / 2.0], axis=-1)


def _make_vgg_sim_fn(net: VGGFeatures, device) -> Callable[[np.ndarray, np.ndarray], torch.Tensor]:
    """Per-frame VGG cosine similarity of (N, H, W, 3) stacks, EMBED_CHUNK
    frames a pass on `device`. :return: (N,) on the host."""

    @torch.no_grad()
    def fn(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
        sims = []
        for i in range(0, len(a), EMBED_CHUNK):
            fa = net(torch.from_numpy(a[i:i + EMBED_CHUNK]).to(device))
            fb = net(torch.from_numpy(b[i:i + EMBED_CHUNK]).to(device))
            sims.append(vgg_cosine_similarity(fa, fb).cpu())
        return torch.cat(sims)

    return fn


def _section(times, name: str):
    """`times.section(name)` (cli.common.RunTimes), or nothing without one."""
    return times.section(name) if times is not None else contextlib.nullcontext()


def _frames(camera, count: int) -> np.ndarray:
    return np.stack([camera.get_frame(i) for i in range(count)]).astype(np.float32)


def _same_videos(reference: MulticameraVideoDataset, generated: MulticameraVideoDataset):
    if len(reference.videos) != len(generated.videos):
        # Zipping would silently truncate (or mispair) a tree from a
        # generation run that died halfway.
        raise ValueError("reference and generated datasets should have the same videos: "
                         f"{len(reference.videos)} vs {len(generated.videos)}")


class ReconstructedDatasetEvaluator:
    """Paired evaluation of a generated dataset tree against its reference.
    Windows of `window_size` frames feed the motion-masked MSE."""

    def __init__(self, window_size: int = 16, compute_fid: bool = True, device="cuda", times=None):
        """:param device: where the metric networks and image metrics run.
        :param times: cli.common.RunTimes, or None."""
        self.window_size = window_size
        self.compute_fid = compute_fid
        self.device = resolve_device(device)
        self.times = times
        self._vgg_sim_fn = _make_vgg_sim_fn(init_vgg19(cuts=3, device=self.device, seed=0), self.device)

    def _on_frames(self, video_idx: int, camera_idx: int, ref_frames: np.ndarray, gen_frames: np.ndarray) -> None:
        """Subclass hook over each already-decoded (T, H, W, 3) stack pair."""

    @torch.no_grad()
    def _image_metrics(self, ref_frames: np.ndarray, gen_frames: np.ndarray):
        """Per-frame (MSE, PSNR, SSIM) and the windows' motion-masked MSEs."""
        per_frame = []
        for i in range(0, len(ref_frames), EMBED_CHUNK):
            a = torch.from_numpy(ref_frames[i:i + EMBED_CHUNK]).to(self.device)
            b = torch.from_numpy(gen_frames[i:i + EMBED_CHUNK]).to(self.device)
            per_frame.append(torch.stack([metrics_lib.mse(a, b), metrics_lib.psnr(a, b), metrics_lib.ssim(a, b)]))
        m, p, s = torch.cat(per_frame, dim=1).cpu().numpy()
        masked = []
        for start in range(0, len(ref_frames) - self.window_size + 1, self.window_size):
            window = slice(start, start + self.window_size)
            masked.append(float(metrics_lib.motion_masked_mse(torch.from_numpy(ref_frames[window]).to(self.device),
                                                              torch.from_numpy(gen_frames[window]).to(self.device))))
        return m, p, s, masked

    def compute_metrics(self, reference_root: str, generated_root: str) -> Dict[str, float]:
        reference = MulticameraVideoDataset(reference_root, observations_count=1)
        generated = MulticameraVideoDataset(generated_root, observations_count=1)
        _same_videos(reference, generated)

        mses, psnrs, ssims, masked_mses, vgg_sims = [], [], [], [], []
        fid = IncrementalFID(device=self.device) if self.compute_fid else None

        for video_idx, (ref_video, gen_video) in enumerate(zip(reference.videos, generated.videos)):
            for camera_idx in range(ref_video.cameras_count):
                ref_cam = ref_video.videos[camera_idx]
                gen_cam = gen_video.videos[camera_idx]
                frames_count = min(ref_cam.frames_count, gen_cam.frames_count)
                with _section(self.times, "decode"):
                    ref_frames = _frames(ref_cam, frames_count)
                    gen_frames = _frames(gen_cam, frames_count)

                with _section(self.times, "metrics"):
                    m, p, s, masked = self._image_metrics(ref_frames, gen_frames)
                    mses.extend(m.tolist())
                    psnrs.extend(p.tolist())
                    ssims.extend(s.tolist())
                    masked_mses.extend(masked)

                with _section(self.times, "networks"):
                    vgg_sims.extend(self._vgg_sim_fn(ref_frames, gen_frames).numpy().tolist())
                    if fid is not None:
                        fid.update_reference(ref_frames)
                        fid.update_generated(gen_frames)
                    # The playability evaluator folds its FVD in here, so
                    # that every frame is decoded once.
                    self._on_frames(video_idx, camera_idx, ref_frames, gen_frames)

        results = {
            "mse": float(np.mean(mses)),
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
        }
        if masked_mses:
            results["motion_masked_mse"] = float(np.mean(masked_mses))
        if vgg_sims:
            # Random-weight features are self-consistent but not comparable
            # with a pretrained VGG's number: the key says so.
            results["vgg_cosine_similarity_selfconsistent"] = float(np.mean(vgg_sims))
        if fid is not None:
            with _section(self.times, "metrics"):
                results["fid"] = fid.compute()
        return results


class ReconstructedPlayabilityDatasetEvaluator(ReconstructedDatasetEvaluator):
    """Adds the action-space diagnostics and FVD over the re-enacted
    dataset's clips of CLIP_LENGTH frames."""

    CLIP_LENGTH = 8  # the JAX evaluator's default, which its CLI keeps

    def __init__(self, actions_count: int, plots_directory: Optional[str] = None, **kwargs):
        """:param plots_directory: where the movement density and mean-vector
        plots go (eval.plotting), or None for none."""
        super().__init__(**kwargs)
        self.actions_count = actions_count
        self.plots_directory = plots_directory

    def _on_frames(self, video_idx, camera_idx, ref_frames, gen_frames):
        # FVD over aligned clips of camera 0 only, as the reference's
        # playability FVD.
        if camera_idx != 0:
            return
        clip = self.CLIP_LENGTH
        for start in range(0, ref_frames.shape[0] - clip + 1, clip):
            self._fvd.update_reference(ref_frames[None, start:start + clip])
            self._fvd.update_generated(gen_frames[None, start:start + clip])

    def compute_metrics(self, reference_root: str, generated_root: str) -> Dict[str, float]:
        self._fvd = IncrementalFVD(device=self.device)
        results = super().compute_metrics(reference_root, generated_root)

        # Annotation-only pass (no frame decode): ground-truth movement of
        # the first box against the inferred actions the playability
        # creator recorded.
        with _section(self.times, "metrics"):
            reference = MulticameraVideoDataset(reference_root, observations_count=1)
            generated = MulticameraVideoDataset(generated_root, observations_count=1)
            movements, actions = [], []
            for ref_video, gen_video in zip(reference.videos, generated.videos):
                cam_ref, cam_gen = ref_video.videos[0], gen_video.videos[0]
                frames_count = min(cam_ref.frames_count, cam_gen.frames_count)
                for i in range(frames_count - 1):
                    entry = cam_gen.metadata[i] if i < len(cam_gen.metadata) else {}
                    action = entry.get("inferred_action") if isinstance(entry, dict) else None
                    c0 = box_centers_from_annotations(ref_video, 0, i)
                    c1 = box_centers_from_annotations(ref_video, 0, i + 1)
                    if action is None or len(c0) == 0 or len(c1) == 0:
                        continue
                    movements.append(c1[0] - c0[0])
                    actions.append(int(action))

            if movements:
                movements_np = np.stack(movements)
                actions_np = np.asarray(actions)
                results.update(metrics_lib.action_variance(movements_np, actions_np, self.actions_count))
                results["delta_mse_action_accuracy"] = metrics_lib.delta_mse_action_accuracy(
                    movements_np, actions_np, self.actions_count)
                results["action_classification_score"] = metrics_lib.action_classification_score(
                    movements_np, actions_np)
                if self.plots_directory is not None:
                    from playableenvironments_tpu_torch.eval import plotting

                    plotting.plot_density_2d(actions_np, movements_np, self.actions_count, self.plots_directory,
                                             prefix="world_")
                    plotting.plot_density_2d(actions_np, movements_np, self.actions_count, self.plots_directory,
                                             prefix="world_", merged=True)
                    plotting.plot_mean_vectors_2d(actions_np, movements_np, self.actions_count,
                                                  self.plots_directory, prefix="world_")
                    plotting.plot_density_1d(actions_np, np.linalg.norm(movements_np, axis=-1), self.actions_count,
                                             os.path.join(self.plots_directory, "world_magnitude.png"),
                                             prefix="world_")
            try:
                results["fvd"] = self._fvd.compute()
            except ValueError as error:
                # Too few clips for a covariance: record why instead of
                # dropping the metric silently.
                print(f"FVD computation failed: {error}")
                results["fvd_error"] = str(error)
        return results


class ReconstructedDatasetFVDEvaluator:
    """Standalone FVD over a paired reference/generated dataset tree: every
    camera's aligned clips of `clip_length` frames."""

    def __init__(self, clip_length: int = 16, device="cuda", times=None):
        self.clip_length = clip_length
        self.device = resolve_device(device)
        self.times = times

    def compute_metrics(self, reference_root: str, generated_root: str) -> Dict[str, float]:
        reference = MulticameraVideoDataset(reference_root, observations_count=1)
        generated = MulticameraVideoDataset(generated_root, observations_count=1)
        _same_videos(reference, generated)

        fvd = IncrementalFVD(device=self.device)
        for ref_video, gen_video in zip(reference.videos, generated.videos):
            for camera_idx in range(ref_video.cameras_count):
                ref_cam = ref_video.videos[camera_idx]
                gen_cam = gen_video.videos[camera_idx]
                frames_count = min(ref_cam.frames_count, gen_cam.frames_count)
                if frames_count < self.clip_length:
                    continue
                with _section(self.times, "decode"):
                    ref_frames = _frames(ref_cam, frames_count)
                    gen_frames = _frames(gen_cam, frames_count)
                with _section(self.times, "networks"):
                    for start in range(0, frames_count - self.clip_length + 1, self.clip_length):
                        fvd.update_reference(ref_frames[None, start:start + self.clip_length])
                        fvd.update_generated(gen_frames[None, start:start + self.clip_length])
        with _section(self.times, "metrics"):
            return {"fvd": fvd.compute()}


def save_results_yaml(results: Dict[str, float], path: str):
    """Dump results as YAML (the evaluate_* CLIs' output)."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({k: (v if isinstance(v, str) else float(v)) for k, v in results.items()}, f)
