"""The camera-manipulation and playability creators, the port against the
JAX package on the CPU, on the tiny tennis scene and its 2-player test
split (torch_port_scenes's `roots` and `sessions`; the playable weights
and centroids of test_torch_port_playable_evaluator.py's `setup`), in
windows of 3 frames (each video one window), batch 1 on both sides:

- the same mirror tree and file names, every rendered frame within 1e-2
  of JAX's before quantization (test_torch_port_play.py's frame bound),
  the PNGs within 3/255 after it (test_torch_port_encode.py's), the
  annotations copied byte for byte;
- camera manipulation: the frame-0 state frozen along the trajectory (this
  split's camera does not move, so every frame of a window equals its
  first);
- playability: JAX's action-sampling and gumbel draws replayed into the
  port's animate (the eval-mode path reads them: the posterior's noise and
  the gumbel sample pick the action), the inferred actions written into
  metadata.pkl equal to JAX's, no running statistic or centroid moved.
"""

import copy
import os
import pathlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.data.dataset import MulticameraVideoDataset as JaxDataset
from playableenvironments_tpu.eval import creators as jcreators
from playableenvironments_tpu.render.playable_model import PlayableEnvironmentModel as JaxPlayable
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.eval import creators
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_play import IMAGE, STRIDES
from test_torch_port_playable_evaluator import setup  # noqa: F401  (a fixture)
from torch_port_scenes import roots, sessions  # noqa: F401  (fixtures)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

T = 3  # frames a window: each 3-frame video of the split is one window


class WindowRecorder:
    """A renderer wrapper keeping every rendered (B, T, C, H, W, 3) window
    by (video, first frame)."""

    def __init__(self, renderer, store):
        self.renderer, self.store, self.pending = renderer, store, []

    def encode(self, batch):
        self.pending.append((np.asarray(batch.video_indexes), np.asarray(batch.video_frame_indexes)))
        return self.renderer.encode(batch)

    def render(self, encoding):
        frames = self.renderer.render(encoding)
        videos, indexes = self.pending.pop(0)
        for i, window in enumerate(np.asarray(frames.cpu() if torch.is_tensor(frames) else frames)):
            self.store[(int(videos[i]), int(indexes[i, 0]))] = window[:, 0]
        return frames

    def __getattr__(self, name):
        return getattr(self.renderer, name)


def compare_mirrors(roots, out, frames):
    """Same files, frames within 1e-2, PNGs within 3/255, annotations (all
    but metadata.pkl) byte for byte. :return: the mirror's file names."""
    files = sorted(str(p.relative_to(out["jax"])) for p in pathlib.Path(out["jax"]).rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(out["port"])) for p in pathlib.Path(out["port"]).rglob("*")
                           if p.is_file())
    assert sum(f.endswith(".png") for f in files) == 6 and sorted(frames["port"]) == sorted(frames["jax"])
    for key, ref in frames["jax"].items():
        assert frames["port"][key].shape == (T,) + IMAGE + (3,)
        np.testing.assert_allclose(frames["port"][key], ref, atol=1e-2, rtol=0, err_msg=str(key))
    for name in files:
        if name.endswith(".pkl") and not name.endswith("metadata.pkl"):
            assert pathlib.Path(out["port"], name).read_bytes() == \
                pathlib.Path(roots["tennis"], "test", name).read_bytes(), name
    mirror = MulticameraVideoDataset(out["port"], observations_count=1)
    reference = JaxDataset(out["jax"], observations_count=1)
    assert len(mirror) == 6
    for i in range(len(mirror)):
        np.testing.assert_allclose(mirror[i]["observations"], reference[i]["observations"], atol=3 / 255 + 1e-6,
                                   rtol=0)
    return files


def datasets(roots):
    split = os.path.join(roots["tennis"], "test")
    return JaxDataset(split, observations_count=1), MulticameraVideoDataset(split, observations_count=1)


def port_renderer(session):
    return creators.FrameRenderer(session.renderer.model, session.autoencoder, IMAGE, STRIDES)


def test_camera_manipulation_creator_matches_jax(roots, sessions, tmp_path):
    jsession, session, _ = sessions
    out = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    frames = {"jax": {}, "port": {}}
    jdataset, dataset = datasets(roots)
    jcreators.ReconstructedCameraManipulationDatasetCreator(
        WindowRecorder(jsession.renderer, frames["jax"])).reconstruct_dataset(jdataset, out["jax"], T)
    creators.ReconstructedCameraManipulationDatasetCreator(
        WindowRecorder(port_renderer(session), frames["port"])).reconstruct_dataset(dataset, out["port"], T)
    compare_mirrors(roots, out, frames)
    for window in frames["port"].values():
        for t in range(1, T):
            np.testing.assert_array_equal(window[t], window[0])
    # The frozen encoding: frame 0's objects at every t, the cameras as they are.
    batch = next(dataset.iterate_batches(1, shuffle=False))
    encoding = port_renderer(session).encode(batch)
    frozen = creators.frozen_encoding(encoding)
    for name in ("object_rotations", "object_translations", "object_style", "object_deformation",
                 "object_in_scene"):
        value = getattr(frozen, name)
        assert torch.equal(value, getattr(encoding, name)[:, :1].expand(value.shape)), name
    assert torch.equal(frozen.camera_translations, encoding.camera_translations)


def test_playability_creator_matches_jax(roots, sessions, setup, tmp_path, monkeypatch):
    jsession, session, _ = sessions
    jscene, _, state, trainer, _ = setup
    out = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    frames = {"jax": {}, "port": {}}
    jdataset, dataset = datasets(roots)
    centroids = trainer._per_object_centroids(trainer.centroids)
    with recorded_draws(("normal", "gumbel")) as draws:
        jcreators.ReconstructedPlayabilityDatasetCreator(
            WindowRecorder(jsession.renderer, frames["jax"]), JaxPlayable(jscene),
            {"params": state.params, "batch_stats": state.batch_stats},
            [jnp.asarray(c.numpy()) for c in centroids]).reconstruct_dataset(jdataset, out["jax"], T)
    replay = Replay([(name, np.asarray(value)) for name, value in draws])
    assert len(replay.draws) == 2 * 2 * 6  # 2 windows x 2 players x (posterior, directions, gumbel) twice

    def host_streams(seed, device):
        assert (seed, device) == (0, "cpu")  # drawn on the host: the card re-enacts with the CPU's numbers
        return replay

    monkeypatch.setattr(creators, "RngStreams", host_streams)

    playable = trainer.playable_model
    before = copy.deepcopy(playable.state_dict())
    kept = [c.clone() for c in trainer.centroids]
    creators.ReconstructedPlayabilityDatasetCreator(
        WindowRecorder(port_renderer(session), frames["port"]), playable, centroids,
    ).reconstruct_dataset(dataset, out["port"], T)
    assert not replay.draws
    assert replay.streams == (["action_sampling", "action_sampling", "gumbel"] * 4) * 2
    files = compare_mirrors(roots, out, frames)
    for key, value in playable.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert all(torch.equal(a, b) for a, b in zip(trainer.centroids, kept))
    moved = max(float(np.abs(w[-1] - w[0]).max()) for w in frames["jax"].values())
    assert moved > 1e-3  # the re-enactment moves the players

    metadata = [name for name in files if name.endswith("metadata.pkl")]
    assert len(metadata) == 2
    for name in metadata:
        with open(os.path.join(out["port"], name), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(out["jax"], name), "rb") as f:
            ref = pickle.load(f)
        assert got == ref and [("inferred_action" in e) for e in got] == [True] * (T - 1) + [False]


@pytest.mark.parametrize("observations", [2])
def test_windows_do_not_overlap(roots, observations):
    """The creators' windows start (skip + 1) (T - 1) + 1 frames apart, as
    JAX's: a 3-frame video takes one window of 2 (frames 0-1)."""
    _, dataset = datasets(roots)
    creators._non_overlapping(dataset, observations)
    jdataset = datasets(roots)[0]
    jdataset.set_observations_count(observations, window_stride=(jdataset.skip_frames + 1) * (observations - 1) + 1)
    assert dataset._index == jdataset._index == [(0, 0), (1, 0)]
