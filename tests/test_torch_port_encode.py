"""The eval-mode scene encoding from a dataset batch and its consumers, the
port against the JAX package on the CPU:
- `EnvironmentModel.compute_scene_encoding(train=False)` on a whole scene,
  every SceneEncoding field at 1e-5, no running statistic changed, nothing
  drawn; for configs/synthetic_smoke.yaml (1 player, V5/V4 encoders) on
  data.synthetic's dataset, and for the tiny tennis scene of
  test_torch_port_play.py (2 static objects, 2 players) on a 2-player
  dataset written with Video.add_content;
- `InteractiveSession.initialize(batch)` and two steps against the JAX
  session, frame by frame at 1e-2 (as test_torch_port_play.py);
- `ReconstructedDatasetCreator` (the port at batch 4, the JAX package at
  batch 1) on the test split: the same tree and file names, the rendered
  frames (`FrameRenderer.encode`/`render`) within 1e-2 before quantization
  and the PNGs within 3/255 after it, the annotations copied, the mirror
  loadable as a dataset.
The weights are made by the JAX package (jitted init), perturbed with
seeded numpy and carried over by compat/from_flax.py."""

import copy
import functools
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from playableenvironments_tpu.data.dataset import MulticameraVideoDataset as JaxDataset
from playableenvironments_tpu.eval import creators as jcreators
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.eval.creators import FrameRenderer, ReconstructedDatasetCreator
from test_torch_port_play import ACTIONS, IMAGE, STRIDES
from torch_port_scenes import (  # noqa: F401  (roots, sessions: fixtures)
    F32, NoDraws, dataset_batch, jax_batch, recorded, roots, sessions, smoke_setup, tennis_setup,
)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)


def setup_for(name, roots):
    if name == "smoke":
        jmodel, model, variables, dataset = smoke_setup(roots["smoke"])
    else:
        jmodel, model, _, variables, dataset = tennis_setup(roots["tennis"])
    return jmodel, model, variables, dataset


@pytest.mark.parametrize("name", ["smoke", "tennis"])
def test_eval_scene_encoding_matches_jax(roots, name):
    """Every field at 1e-5 with the running statistics of every (Masked)
    BatchNorm read and none updated, on both sides; nothing drawn."""
    jmodel, model, variables, dataset = setup_for(name, roots)
    count = dataset.observations_count
    dataset.set_observations_count(2)
    batch = dataset_batch(dataset, 3)
    dataset.set_observations_count(count)
    apply = jax.jit(lambda v, *a: jmodel.apply(v, *a, shuffle_style=False, train=False,
                                               method=JaxEnvironmentModel.compute_scene_encoding,
                                               mutable=["batch_stats"]))
    (jencoding, _), mutated = apply(variables, *jax_batch(batch).environment_model_args())
    for path, leaf in jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]):
        ref = functools.reduce(lambda tree, key: tree[key.key], path, variables["batch_stats"])
        np.testing.assert_array_equal(np.asarray(leaf), ref)
    before = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        encoding, _ = model.compute_scene_encoding(*batch.environment_model_args(), train=False, rng=NoDraws())
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
    for field in vars(encoding):
        got, ref = getattr(encoding, field), np.asarray(getattr(jencoding, field))
        assert tuple(got.shape) == ref.shape, field
        if ref.dtype == bool:
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=field)
        else:
            np.testing.assert_allclose(got.numpy(), ref, **F32, err_msg=field)
    assert not bool(encoding.object_in_scene.all()) or name == "smoke"
    # The eval encoding reads the running statistics: train mode (on a copy,
    # since it updates them) differs.
    with torch.no_grad():
        train_style = copy.deepcopy(model).compute_scene_encoding(
            *batch.environment_model_args(), train=True)[0].object_style
    assert not torch.allclose(train_style, encoding.object_style, atol=1e-3)


def test_play_from_a_batch_matches_jax(sessions):
    """initialize(batch) (frame 0 of the batch's first element, encoded in
    eval mode) and two scripted steps, frame by frame at 1e-2."""
    jsession, session, dataset = sessions
    dataset.set_observations_count(1)
    batch = dataset_batch(dataset, 1)
    frames = [(session.initialize(batch), jsession.initialize(jax_batch(batch)))]
    for field in vars(session.encoding):
        np.testing.assert_allclose(getattr(session.encoding, field).numpy(),
                                   np.asarray(getattr(jsession.encoding, field)), **F32, err_msg=field)
    for actions in ACTIONS:
        frames.append((session.step(list(actions)), jsession.step(list(actions))))
    for got, ref in frames:
        assert got.shape == IMAGE + (3,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-2, rtol=0)
    assert np.abs(frames[2][1] - frames[0][1]).max() > 1e-3


def test_reconstructed_dataset_matches_jax(roots, sessions, tmp_path):
    jsession, session, dataset = sessions
    out = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    frames = {"jax": {}, "port": {}}
    jrenderer = recorded(copy.copy(jsession.renderer), frames["jax"])
    jcreators.ReconstructedDatasetCreator(jrenderer, batch_size=1).reconstruct_dataset(
        JaxDataset(os.path.join(roots["tennis"], "test"), observations_count=3), out["jax"])
    renderer = recorded(FrameRenderer(session.renderer.model, session.autoencoder, IMAGE, STRIDES), frames["port"])
    ReconstructedDatasetCreator(renderer, batch_size=4).reconstruct_dataset(
        MulticameraVideoDataset(os.path.join(roots["tennis"], "test"), observations_count=3), out["port"])
    files = sorted(str(p.relative_to(out["jax"])) for p in pathlib.Path(out["jax"]).rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(out["port"])) for p in pathlib.Path(out["port"]).rglob("*")
                           if p.is_file())
    assert sum(f.endswith(".png") for f in files) == 6 and sorted(frames["port"]) == sorted(frames["jax"])
    for key, ref in frames["jax"].items():
        np.testing.assert_allclose(frames["port"][key], ref, atol=1e-2, rtol=0, err_msg=str(key))
    for name in files:
        src = pathlib.Path(roots["tennis"], "test", name)
        if name.endswith(".pkl"):
            assert pathlib.Path(out["port"], name).read_bytes() == src.read_bytes(), name
    mirror = MulticameraVideoDataset(out["port"], observations_count=1)
    assert len(mirror) == 6
    reference = JaxDataset(out["jax"], observations_count=1)
    for i in range(len(mirror)):
        got, ref = mirror[i], reference[i]
        np.testing.assert_allclose(got["observations"], ref["observations"], atol=3 / 255 + 1e-6, rtol=0)
        for key in ("bounding_boxes", "bounding_boxes_validity", "camera_rotations", "focals", "actions"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
