"""Checkpoints of the port's three trainers (train/checkpointing.py), on the
CPU at tiny widths:

- save and restore of each trainer's whole state into a trainer built
  from another seed: every parameter, buffer, Adam moment and count, rate
  group, step, centroid and MI matrix bit for bit;
- a step taken after the restore bit-identical to the step the saved
  trainer takes from the same state and draws (one trainer a phase serves
  both checks: its checkpoint at step 1 is resumed, at step 2 restored);
- a save cut short (killed while it writes) leaves the previous
  checkpoint the latest one;
- the path rules against JAX's `latest_checkpoint`, `checkpoint_step`,
  `latest_checkpoint_any` and `save_checkpoint(keep=)` on the same
  directory listings: names that do not parse, relative and absolute
  directories, missing and empty ones;
- the transfers: `graft_autoencoder` (phase 1's autoencoder into a
  phase-2 model, the checkpoint's tensors exactly) and `restore_params`
  (a phase-2 model into a fresh one, exactly) and where they raise, as
  JAX's do: a model without an autoencoder, a checkpoint of another
  architecture;
- the bridge from JAX: an orbax checkpoint written by JAX's
  `save_checkpoint`, passed through scripts/export_flax_checkpoint.py and
  `compat/from_flax.py::load_npz`, loads the same tensors as the in-memory
  flax tree and decodes alike (exactly); the export's key escaping keeps
  flax names that hold "/".
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.train import checkpointing as jax_checkpointing
from playableenvironments_tpu.train.state import create_train_state
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.compat.from_flax import load_autoencoder, load_npz
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.models.autoencoder import MultiresAutoencoder
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.train import checkpointing, trainer_autoencoder, trainer_playable
from playableenvironments_tpu_torch.train import trainer_synthesis
from playableenvironments_tpu_torch.utils.random import RngStreams
from test_torch_port_decoder import AE, autoencoder_variables, decoder_scene
from test_torch_port_decoder import batch_arrays as decoder_arrays
from test_torch_port_decoder import training_config as decoder_training_config
from test_torch_port_phase3 import encoding_arrays
from test_torch_port_phase3 import scene as phase3_scene
from test_torch_port_phase3 import training_config as phase3_training_config
from test_torch_port_train import fused_scene, to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

PHASES = ("autoencoder", "synthesis", "playable")
CAMERA_MEMORY = 4


def t(x):
    return torch.from_numpy(np.array(x))


def make_trainer(phase, seed):
    """A tiny trainer of `phase` and a step function of it (draws from
    RngStreams(seed), so that two trainers can take the same step)."""
    if phase == "autoencoder":
        trainer = trainer_autoencoder.AutoencoderTrainer(
            port_config.AutoencoderConfig(**AE), trainer_autoencoder.AutoencoderTrainingConfig(), device="cpu",
            seed=seed)
        images = t(np.random.default_rng(0).random((2, 32, 32, 3), np.float32))
        return trainer, lambda rng_seed: trainer.train_step(images, RngStreams(rng_seed, "cpu"))
    if phase == "synthesis":
        # The decoder path with camera offsets: three rate groups, the
        # autoencoder's frozen for the first step.
        model = EnvironmentModel(to_port(decoder_scene()), enable_camera_offsets=True,
                                 camera_memory_size=CAMERA_MEMORY, device="cpu", seed=seed)
        cfg = dataclasses.replace(decoder_training_config(trainer_synthesis), perturb=True, shuffle_style=True,
                                  camera_parameters_learning_rate=1e-3)
        trainer = trainer_synthesis.SynthesisTrainer(model, cfg)
        arrays = decoder_arrays()
        arrays["global_frame_indexes"] = np.asarray([[0, 1], [2, 3]], np.int32)
        batch = Batch(**{k: t(v) for k, v in arrays.items()})
        return trainer, lambda rng_seed: trainer.train_step(batch, RngStreams(rng_seed, "cpu"))
    model = PlayableEnvironmentModel(to_port(phase3_scene()), with_discriminators=True, device="cpu", seed=seed)
    trainer = trainer_playable.PlayableTrainer(model, phase3_training_config(trainer_playable))
    encoding = SceneEncoding(**{k: t(v) for k, v in encoding_arrays().items()})
    trainer.init_state_from_encoding(encoding, seed=seed)
    return trainer, lambda rng_seed: trainer.fused_step(encoding, RngStreams(rng_seed, "cpu"))


def flat_state(trainer):
    return checkpointing.flat_state(trainer)


def assert_same_state(got, ref):
    difference = checkpointing.state_difference(got, ref)
    assert difference is None, difference


_RUNS = {}


def phase_run(phase, tmp_path_factory):
    """One trainer per phase, shared by the round-trip and resumed-step
    tests: it takes step 1 and is saved; a trainer of another seed restores
    that checkpoint and both take the same step 3 (the resumed step); the
    first, now at step 2, is saved again and restored into a third trainer
    (the round trip)."""
    if phase in _RUNS:
        return _RUNS[phase]
    directory = tmp_path_factory.mktemp(f"checkpoint_{phase}")
    trainer, step = make_trainer(phase, seed=0)
    step(1)
    first = checkpointing.save_checkpoint(str(directory / "first"), trainer)
    resumed, resumed_step = make_trainer(phase, seed=7)
    checkpointing.restore_checkpoint(first, resumed)
    metrics, resumed_metrics = step(3), resumed_step(3)
    run = {"resumed": (flat_state(resumed), flat_state(trainer), metrics, resumed_metrics, resumed.step, trainer.step)}
    path = checkpointing.save_checkpoint(str(directory / "second"), trainer)
    fresh, _ = make_trainer(phase, seed=5)
    before = flat_state(fresh)
    assert checkpointing.restore_checkpoint(path, fresh) is fresh
    run["round_trip"] = (str(directory / "second"), path, before, flat_state(fresh), flat_state(trainer),
                         {g["name"] for g in fresh.optimizer.optimizer.param_groups})
    _RUNS[phase] = run
    return run


@pytest.mark.parametrize("phase", PHASES)
def test_round_trip_is_bit_exact(phase, tmp_path_factory):
    directory, path, before, restored, saved, groups = phase_run(phase, tmp_path_factory)["round_trip"]
    assert path == os.path.join(directory, "checkpoint_2") and os.listdir(path) == [checkpointing.STATE_FILE]
    assert_same_state(restored, saved)
    moments = [p for p in saved if "exp_avg_sq" in p]
    assert moments and any(not torch.equal(before[p], saved[p]) for p in saved
                           if p in before and torch.is_tensor(saved[p]))
    if phase == "synthesis":
        assert groups == {"__main__", "autoencoder", "camera_offsets"}


@pytest.mark.parametrize("phase", PHASES)
def test_resumed_step_is_bit_identical(phase, tmp_path_factory):
    resumed, trainer, metrics, resumed_metrics, resumed_step, step = phase_run(phase, tmp_path_factory)["resumed"]
    assert_same_state(resumed, trainer)
    for name, value in metrics.items():
        assert torch.equal(resumed_metrics[name], value), name
    assert resumed_step == step == 2


def test_restore_checks_the_trainer(tmp_path):
    """A checkpoint of another phase, or of another architecture, raises."""
    trainer, step = make_trainer("autoencoder", seed=0)
    step(1)
    path = checkpointing.save_checkpoint(str(tmp_path), trainer)
    other, _ = make_trainer("playable", seed=0)
    with pytest.raises(ValueError, match="autoencoder state"):
        checkpointing.restore_checkpoint(path, other)
    wider = trainer_autoencoder.AutoencoderTrainer(
        port_config.AutoencoderConfig(**dict(AE, bottleneck_features=32)),
        trainer_autoencoder.AutoencoderTrainingConfig(), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpointing.restore_checkpoint(path, wider)


def test_a_save_cut_short_leaves_the_previous_checkpoint_latest(tmp_path, monkeypatch):
    """A save killed while it writes leaves only `checkpoint_<step>.tmp/`:
    latest_checkpoint still returns the previous checkpoint, which
    restores; the next save of that step replaces the leftover."""
    trainer, step = make_trainer("autoencoder", seed=0)
    step(1)
    previous = checkpointing.save_checkpoint(str(tmp_path), trainer)
    saved = flat_state(trainer)
    step(2)
    real_save = torch.save

    def killed(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpointing.torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        checkpointing.save_checkpoint(str(tmp_path), trainer)
    monkeypatch.setattr(checkpointing.torch, "save", real_save)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_1", "checkpoint_2.tmp"]
    assert checkpointing.latest_checkpoint(str(tmp_path)) == previous
    assert checkpointing.latest_checkpoint_any(str(tmp_path)) == previous
    fresh, _ = make_trainer("autoencoder", seed=3)
    checkpointing.restore_checkpoint(previous, fresh)
    assert_same_state(flat_state(fresh), saved)
    path = checkpointing.save_checkpoint(str(tmp_path), trainer)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_1", "checkpoint_2"]
    assert checkpointing.latest_checkpoint(str(tmp_path)) == path


# ---- the path rules, against JAX's -------------------------------------------------


def jax_state(step=7):
    return create_train_state({"w": jnp.zeros(3)}, {}, optax.adam(1e-3)).replace(step=jnp.asarray(step, jnp.int32))


def test_path_rules_match_jax(tmp_path, monkeypatch):
    listings = {
        "a": ["checkpoint_3", "checkpoint_12", "checkpoint_x", "checkpoint_", "checkpoint_2_7", "other_99",
              "checkpoint_-1"],
        "b": ["checkpoint_5", "checkpoint_40.tmp", "checkpoint_11", "checkpoint_011"],
        "c": ["checkpoint_x", "notes"],
        "empty": [],
    }
    for directory, names in listings.items():
        os.makedirs(tmp_path / directory)
        for name in names:
            os.makedirs(tmp_path / directory / name)
    monkeypatch.chdir(tmp_path)
    directories = list(listings) + ["missing", str(tmp_path / "a"), "./b"]
    for directory in directories:
        got = checkpointing.latest_checkpoint(directory)
        assert got == jax_checkpointing.latest_checkpoint(directory), directory
        assert got is None or os.path.isabs(got)
    assert checkpointing.latest_checkpoint("a") == str(tmp_path / "a" / "checkpoint_12")
    for path in (None, "", "checkpoint_7", "x/checkpoint_7", "checkpoint_7/", "checkpoint_x", "runs_2/checkpoint",
                 "a_b_-3", "checkpoint_0"):
        assert checkpointing.checkpoint_step(path) == jax_checkpointing.checkpoint_step(path), path
    for group in (("a", "b"), ("b", "a"), ("c", "empty", "missing"), (), ("missing", "b"), ("b", "./b")):
        assert checkpointing.latest_checkpoint_any(*group) == jax_checkpointing.latest_checkpoint_any(*group), group


def test_keep_prunes_as_jax(tmp_path, monkeypatch):
    """Both prune the same listing to the same names, a relative directory
    included; the new checkpoint is step 7."""
    names = ["checkpoint_1", "checkpoint_4", "checkpoint_x", "checkpoint_10", "notes"]
    for root in ("jax", "port"):
        for name in names:
            os.makedirs(tmp_path / root / name)
    monkeypatch.chdir(tmp_path)
    jax_checkpointing.save_checkpoint("jax", jax_state(7), keep=2)
    trainer, _ = make_trainer("autoencoder", seed=0)
    trainer.optimizer.step_count = 7
    path = checkpointing.save_checkpoint("port", trainer, keep=2)
    assert path == str(tmp_path / "port" / "checkpoint_7")
    listed = {root: sorted(n for n in os.listdir(tmp_path / root) if "tmp" not in n) for root in ("jax", "port")}
    assert listed["port"] == listed["jax"] == ["checkpoint_10", "checkpoint_7", "checkpoint_x", "notes"]


# ---- the transfers between phases ------------------------------------------------


def test_graft_and_restore_params_carry_the_tensors(tmp_path):
    phase1, step1 = make_trainer("autoencoder", seed=0)
    step1(1)
    ae_path = checkpointing.save_checkpoint(str(tmp_path / "phase1"), phase1)
    phase2, step2 = make_trainer("synthesis", seed=3)
    checkpointing.graft_autoencoder(ae_path, phase2.model)
    for name, value in phase1.model.state_dict().items():
        assert torch.equal(phase2.model.autoencoder.state_dict()[name], value), name
    step2(4)
    model_path = checkpointing.save_checkpoint(str(tmp_path / "phase2"), phase2)
    fresh = EnvironmentModel(to_port(decoder_scene()), enable_camera_offsets=True, camera_memory_size=CAMERA_MEMORY,
                             device="cpu", seed=9)
    assert checkpointing.restore_params(model_path, fresh) is fresh
    for name, value in phase2.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name


def test_transfers_raise_where_jax_raises(tmp_path):
    """JAX's graft raises ValueError for a state without an autoencoder,
    and its restore_params for a template of another tree; so do the
    port's, for a model without one and a module of another architecture."""
    path = jax_checkpointing.save_checkpoint(str(tmp_path / "jax"), jax_state())
    with pytest.raises(ValueError, match="no autoencoder"):
        jax_checkpointing.graft_autoencoder(path, jax_state())
    with pytest.raises((ValueError, KeyError, TypeError)):
        jax_checkpointing.restore_params(path, {"v": jnp.zeros(3)}, {})
    phase1, _ = make_trainer("autoencoder", seed=0)
    ae_path = checkpointing.save_checkpoint(str(tmp_path / "port"), phase1)
    without = EnvironmentModel(to_port(fused_scene(use_fused_backbone=False)), device="cpu")
    with pytest.raises(ValueError, match="no autoencoder"):
        checkpointing.graft_autoencoder(ae_path, without)
    with pytest.raises(ValueError, match="missing"):
        checkpointing.restore_params(ae_path, without)
    phase2, _ = make_trainer("synthesis", seed=0)
    model_path = checkpointing.save_checkpoint(str(tmp_path / "port2"), phase2)
    with pytest.raises(ValueError, match="not phase 1's"):
        checkpointing.graft_autoencoder(model_path, phase2.model)


# ---- JAX checkpoints into the port ------------------------------------------------------


def export_module():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "export_flax_checkpoint.py")
    spec = importlib.util.spec_from_file_location("export_flax_checkpoint", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_orbax_checkpoint_reaches_the_port_through_npz(tmp_path):
    variables = autoencoder_variables(jax_config.AutoencoderConfig(**AE), seed=4)
    state = create_train_state(variables["params"], variables["batch_stats"], optax.adam(1e-3)).replace(
        step=jnp.asarray(5, jnp.int32))
    path = jax_checkpointing.save_checkpoint(str(tmp_path / "jax"), state)
    export_module().main([path, str(tmp_path / "ae.npz")])
    tree, step = load_npz(str(tmp_path / "ae.npz"))
    assert step == 5
    from_file = MultiresAutoencoder(port_config.AutoencoderConfig(**AE), device="cpu", seed=0)
    load_autoencoder(from_file, tree)
    in_memory = MultiresAutoencoder(port_config.AutoencoderConfig(**AE), device="cpu", seed=1)
    load_autoencoder(in_memory, variables)
    for name, value in in_memory.state_dict().items():
        assert torch.equal(from_file.state_dict()[name], value), name
    rng = np.random.default_rng(5)
    levels = [t(rng.normal(size=(2, 8, 8, 8)).astype(np.float32)), t(rng.normal(size=(2, 4, 4, 16)).astype(np.float32))]
    with torch.no_grad():
        assert torch.equal(from_file.decode(levels, train=False), in_memory.decode(levels, train=False))


def test_export_keys_keep_flax_names_with_slashes(tmp_path):
    """The spectral norms' state is keyed "layer/kernel/u" inside one flax
    dict: the export escapes the "/" and load_npz restores the name."""
    rng = np.random.default_rng(6)
    tree = {"params": {"discriminator_0": {"conv_0": {"kernel": rng.normal(size=(3, 2, 4)).astype(np.float32)},
                                           "odd%name": {"bias": np.zeros(2, np.float32)}}},
            "batch_stats": {"discriminator_0": {"SpectralNorm_0": {
                "conv_0/kernel/u": rng.normal(size=(1, 4)).astype(np.float32),
                "conv_0/kernel/sigma": np.ones((), np.float32)}}}}
    module = export_module()
    arrays = {}
    for kind in ("params", "batch_stats"):
        module.flatten(tree[kind], kind, arrays)
    np.savez(tmp_path / "tree.npz", step=np.asarray(3), **arrays)
    got, step = load_npz(str(tmp_path / "tree.npz"))
    assert step == 3
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
