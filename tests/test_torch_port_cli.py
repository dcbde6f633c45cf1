"""The port's CLIs end to end on the CPU (`--device cpu`), called in-process
as tests/test_cli_end_to_end.py calls the JAX package's, on
configs/synthetic_smoke.yaml over data.synthetic's dataset (one video of 11
frames at 16x24):

- phase 1 (`train_autoencoder`) with an `autoencoder_training:` block that
  wins over `training:`: 4 steps, the AutoencoderEvaluator's grid at steps
  2 and 4, checkpoint_4;
- phase 2 (`train`): metrics rows at the logging steps (2 and 4), the
  TrainingEvaluator's row and grid at step 4, checkpoints at the save
  steps (2 and 4);
- a phase-2 run stopped at step 3 and resumed to 4 saves a checkpoint_4
  equal bit for bit to the uninterrupted run's (the same data and draws at
  step 4: the loop starts where the uninterrupted run would be, and a
  step's draws come from the seed and the step);
- phase 3 (`train_playable`) with steps_per_call 3 over 4 batches an epoch
  (a block, then the epoch's remainder as a single step): its logs, named
  saves, quick saves and final step equal those of the JAX package's own
  loop (cli/train_playable.py:306-349) run on the same config and dataset,
  with stubs for its trainer, frozen weights, encodings and checkpoint
  writes (`jax_phase3_schedule`): logs at 3, 4 and 7; named saves at 4 and
  7 (7 >= max_steps 6: the last block carries the count past it); one
  quick save at 3; a second run reloads the encoding cache, a run on other
  frozen weights rebuilds it;
- `play --script 0,1,2`: 4 frames, a gif and an mp4;
- options the port does not take raise NotImplementedError, and every CLI
  raises without a card unless `--device cpu` is given.
Exact checks (file names, steps, bit-for-bit states); no tolerance.
"""

import importlib
import json
import os
import sys

import pytest
import torch
import yaml

from playableenvironments_tpu_torch.data.synthetic import make_synthetic_dataset
from playableenvironments_tpu_torch.train import checkpointing
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = "playableenvironments_tpu_torch.cli."


def run_cli(module, *args):
    argv = sys.argv
    sys.argv = [CLI + module] + [str(a) for a in args]
    try:
        return importlib.import_module(CLI + module).main()
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    data_root = os.path.join(root, "data")
    make_synthetic_dataset(data_root, videos=1, frames=11, height=16, width=24)
    with open(os.path.join(REPO, "configs", "synthetic_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["data_root"] = data_root
    cfg["logging"].update(output_root=os.path.join(root, "results"), checkpoints_root=os.path.join(root, "checkpoints"))
    cfg["training"].update(max_steps=4, save_freq=2, log_interval_steps=2, eval_freq=4, quick_save_freq=100)
    cfg["playable_model_training"].update(max_steps=6, steps_per_call=3, log_interval_steps=2, save_freq=4,
                                          quick_save_freq=3, observations_count_steps=10)
    return {"root": str(root), "cfg": cfg}


def write_config(workdir, name, cfg):
    cfg = {**cfg, "logging": {**cfg["logging"], "run_name": name}}
    path = os.path.join(workdir["root"], f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def results_dir(workdir, name):
    return os.path.join(workdir["cfg"]["logging"]["output_root"], name)


def checkpoints_dir(workdir, name, *sub):
    return os.path.join(workdir["cfg"]["logging"]["checkpoints_root"], name, *sub)


def metrics_rows(workdir, name):
    with open(os.path.join(results_dir(workdir, name), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_phase1_cli_writes_checkpoints_and_the_evaluator_grid(workdir):
    cfg = dict(workdir["cfg"])
    cfg["model"] = {**cfg["model"], "autoencoder": {"input_features": 3, "bottleneck_features": 8,
                                                    "bottleneck_blocks": 1, "downsampling_layers_count": [1, 1]}}
    # Phase-2 settings under training:; the autoencoder_training block wins.
    cfg["autoencoder_training"] = {"learning_rate": 0.0004, "max_steps": 4, "batch_size": 2, "save_freq": 4,
                                   "log_interval_steps": 2, "eval_freq": 2, "loss_weights": {"KL_loss_lambda": 5e-6}}
    run_cli("train_autoencoder", "--config", write_config(workdir, "smoke_ae", cfg), "--device", "cpu")
    assert checkpointing.latest_checkpoint(checkpoints_dir(workdir, "smoke_ae")).endswith("checkpoint_4")
    images = sorted(os.listdir(os.path.join(results_dir(workdir, "smoke_ae"), "images")))
    assert images == ["00000002_autoencoder_reconstruction.png", "00000004_autoencoder_reconstruction.png"]
    rows = metrics_rows(workdir, "smoke_ae")
    assert [r["step"] for r in rows if "loss" in r] == [2, 4]
    assert [r["step"] for r in rows if "val_reconstruction_loss" in r] == [2, 4]


@pytest.fixture(scope="module")
def phase2(workdir):
    """The uninterrupted 4-step phase-2 run."""
    run_cli("train", "--config", write_config(workdir, "smoke", workdir["cfg"]), "--device", "cpu")
    return checkpoints_dir(workdir, "smoke")


def test_phase2_cli_logs_saves_and_evaluates_on_schedule(workdir, phase2):
    assert sorted(os.listdir(phase2)) == ["checkpoint_2", "checkpoint_4"]
    rows = metrics_rows(workdir, "smoke")
    assert [r["step"] for r in rows if "loss" in r] == [2, 4]
    assert all("steps_per_sec" in r for r in rows if "loss" in r)
    assert [r["step"] for r in rows if "eval_psnr" in r] == [4]
    assert os.listdir(os.path.join(results_dir(workdir, "smoke"), "images")) == ["00000004_eval_render.png"]
    with open(os.path.join(results_dir(workdir, "smoke"), "timing_train.json")) as f:
        timing = json.load(f)
    assert set(timing["seconds"]) == {"startup", "steps", "saves", "evaluation"}
    assert len(timing["step_seconds"]) == 4
    assert sum(timing["step_seconds"]) == pytest.approx(timing["seconds"]["steps"], rel=1e-3)


def test_resumed_phase2_run_equals_the_uninterrupted_one(workdir, phase2):
    cfg = {**workdir["cfg"], "training": {**workdir["cfg"]["training"], "max_steps": 3}}
    config = write_config(workdir, "smoke_resumed", cfg)
    run_cli("train", "--config", config, "--device", "cpu")
    directory = checkpoints_dir(workdir, "smoke_resumed")
    assert sorted(os.listdir(directory)) == ["checkpoint_2", "checkpoint_3"]
    run_cli("train", "--config", config, "--max_steps", 4, "--device", "cpu")
    with open(os.path.join(results_dir(workdir, "smoke_resumed"), "log.txt")) as f:
        assert f"resumed from {os.path.join(directory, 'checkpoint_3')} at step 3" in f.read()
    resumed = checkpointing.saved_flat_state(os.path.join(directory, "checkpoint_4"))
    whole = checkpointing.saved_flat_state(os.path.join(phase2, "checkpoint_4"))
    assert checkpointing.state_difference(resumed, whole) is None
    # Not vacuous: step 3's state differs from step 4's.
    assert checkpointing.state_difference(checkpointing.saved_flat_state(os.path.join(directory, "checkpoint_3")),
                                          whole) is not None


@pytest.fixture(scope="module")
def phase3(workdir, phase2):
    config = write_config(workdir, "smoke_playable", workdir["cfg"])
    environment = os.path.join(phase2, "checkpoint_4")
    run_cli("train_playable", "--config", config, "--environment_checkpoint", environment, "--device", "cpu")
    return config, environment, checkpoints_dir(workdir, "smoke_playable", "playable")


def jax_phase3_schedule(workdir, monkeypatch):
    """The JAX package's phase-3 CLI (cli/train_playable.py::main) on the
    workdir's config and dataset, its loop as written (blocks of
    steps_per_call through jax.lax.scan, the epoch's remainder, `crossed`
    housekeeping, the final save) and its EncodingCache's windows and
    batches, with stubs for what costs compiles: the trainers (a step adds 1
    to the step), the frozen phase-2 weights, the encodings (zeros) and the
    checkpoint writes (recorded). :return: (logged steps, named save steps,
    quick save steps, final step)."""
    import types
    from typing import Any, NamedTuple

    import jax.numpy as jnp
    import numpy as np

    from playableenvironments_tpu.cli import common, train_playable  # noqa: F401  (imported before the patches)
    from playableenvironments_tpu.train import checkpointing as jax_checkpointing
    from playableenvironments_tpu.train import encoding_cache, trainer_playable, trainer_synthesis

    class State(NamedTuple):
        step: Any

    def fused_step(self, state, encoding, key):
        return State(state.step + 1), {"loss": jnp.zeros(())}

    # Methods of the real classes, so that a module that imports a class
    # while they are patched keeps the class itself.
    monkeypatch.setattr(trainer_playable.PlayableTrainer, "init_state",
                        lambda self, *args, **kwargs: State(jnp.zeros((), jnp.int32)))
    monkeypatch.setattr(trainer_playable.PlayableTrainer, "fused_step", fused_step)
    monkeypatch.setattr(trainer_synthesis.SynthesisTrainer, "init_state",
                        lambda self, key, example: types.SimpleNamespace(params={}, batch_stats={}))

    def build(cls, encode_fn, dataset, key, batch_size=32, log_fn=None):
        slices, start = [], 0
        for video in dataset.videos:
            slices.append((start, video.frames_count))
            start += video.frames_count
        return cls({"zeros": np.zeros((start, 1), np.float32)}, slices, dataset.skip_frames)

    saves = []
    monkeypatch.setattr(jax_checkpointing, "restore_params", lambda path, params, stats: (params, stats))
    monkeypatch.setattr(jax_checkpointing, "save_checkpoint",
                        lambda directory, state, step=None, keep=None: saves.append((directory, int(state.step))))
    monkeypatch.setattr(encoding_cache, "params_fingerprint", lambda params: 0.0)
    monkeypatch.setattr(encoding_cache.EncodingCache, "build", classmethod(build))
    monkeypatch.setattr(encoding_cache.EncodingCache, "save", lambda self, path, fingerprint=0.0: None)
    monkeypatch.setattr(sys, "argv", ["train_playable", "--config",
                                      write_config(workdir, "smoke_playable_jax", workdir["cfg"]),
                                      "--environment_checkpoint", "unused"])
    train_playable.main()
    directory = checkpoints_dir(workdir, "smoke_playable_jax", "playable")
    named = sorted({step for d, step in saves if d == directory})
    quick = sorted({step for d, step in saves if d == os.path.join(directory, "quick")})
    logged = [r["step"] for r in metrics_rows(workdir, "smoke_playable_jax")]
    return logged, named, quick, saves[-1][1]


def test_phase3_schedule_matches_the_jax_loop(workdir, phase3, monkeypatch):
    _, _, directory = phase3
    logged, named, quick, final = jax_phase3_schedule(workdir, monkeypatch)
    assert (logged, named, quick, final) == ([3, 4, 7], [4, 7], [3], 7)  # not vacuous: blocks, remainder, carry
    assert sorted(os.listdir(directory)) == [f"checkpoint_{s}" for s in named] + ["encoding_cache.npz", "quick"]
    assert os.listdir(os.path.join(directory, "quick")) == [f"checkpoint_{s}" for s in quick]
    rows = metrics_rows(workdir, "smoke_playable")
    assert [r["step"] for r in rows] == logged
    assert all("object_1_translations_reconstruction_loss" in r and "loss" in r for r in rows)
    state = checkpointing.saved_flat_state(os.path.join(directory, f"checkpoint_{final}"))
    assert state[("step",)] == final and ("discriminator_optimizer",) not in {k[:1] for k in state}


def test_phase3_reloads_its_encoding_cache_and_rebuilds_a_stale_one(workdir, phase2, phase3):
    config, environment, directory = phase3
    log = os.path.join(results_dir(workdir, "smoke_playable"), "log.txt")
    run_cli("train_playable", "--config", config, "--environment_checkpoint", environment, "--device", "cpu")
    with open(log) as f:
        text = f.read()
    assert f"loaded encoding cache from {os.path.join(directory, 'encoding_cache.npz')}" in text
    assert "rebuilding" not in text
    run_cli("train_playable", "--config", config, "--environment_checkpoint", os.path.join(phase2, "checkpoint_2"),
            "--device", "cpu")
    with open(log) as f:
        assert "was built from different frozen env weights" in f.read().split("loaded encoding cache")[-1]


def test_play_cli_writes_frames_gif_and_mp4(workdir, phase2, phase3):
    config, environment, directory = phase3
    output = os.path.join(workdir["root"], "play")
    frames = run_cli("play", "--config", config, "--environment_checkpoint", environment, "--playable_checkpoint",
                     os.path.join(directory, "checkpoint_7"), "--script", "0,1,2", "--output", output,
                     "--device", "cpu")
    assert len(frames) == 4 and all(f.shape == (16, 24, 3) for f in frames)
    assert sorted(os.listdir(os.path.join(output, "frames"))) == [f"0000{i}.png" for i in range(4)]
    assert {"sequence.gif", "sequence.mp4", "timing_play.json"} <= set(os.listdir(output))
    assert os.path.getsize(os.path.join(output, "sequence.mp4")) > 0


@pytest.mark.parametrize("module", ["train", "train_autoencoder", "train_playable", "play"])
def test_options_the_port_does_not_take_raise(workdir, module, monkeypatch):
    """A training or evaluation mesh beyond one device, and a run of several
    processes (steps_per_call's multi-process blocks among them), name the
    ROADMAP item."""
    args = ["--environment_checkpoint", "x", "--playable_checkpoint", "x"] if module == "play" else (
        ["--environment_checkpoint", "x"] if module == "train_playable" else [])
    for section in ("training", "evaluation"):
        cfg = {**workdir["cfg"], section: {**workdir["cfg"].get(section, {}), "mesh": {"data": 1, "rays": 2}}}
        with pytest.raises(NotImplementedError, match="ROADMAP queue A, Data parallelism"):
            run_cli(module, "--config", write_config(workdir, "mesh", cfg), *args, "--device", "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, Data parallelism"):
        run_cli(module, "--config", write_config(workdir, "processes", workdir["cfg"]), *args, "--device", "cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no card is present")
@pytest.mark.parametrize("module,args", [
    ("train", []), ("train_autoencoder", []), ("train_playable", ["--environment_checkpoint", "x"]),
    ("play", ["--environment_checkpoint", "x", "--playable_checkpoint", "x"]),
    ("import_checkpoint", ["--torch_checkpoint", "x"]),
])
def test_each_cli_raises_without_a_card(workdir, module, args):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(module, "--config", write_config(workdir, "card", workdir["cfg"]), *args)


def test_debug_nans_raise_at_the_module_that_makes_them():
    """`debug_nans: true` in a training section: a module whose output holds
    a NaN raises FloatingPointError there, a backward that makes one raises
    through anomaly detection; both undone on exit, nothing without it."""
    from playableenvironments_tpu_torch.cli.common import apply_debug_flags

    linear = torch.nn.Linear(2, 2)
    nan = torch.tensor([[float("nan"), 0.0]])
    with apply_debug_flags({"playable_model_training": {"debug_nans": True}}):
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="Linear"):
            linear(nan)
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0).sum().backward()
    assert not torch.is_anomaly_enabled()
    linear(nan)
    with apply_debug_flags({"training": {}}):
        linear(nan)


def test_profile_window_traces_once(tmp_path):
    """The window [2, 3) opens at step 2 and writes one chrome trace under
    <results>/profile when step 3 ends; later steps and close() add none."""
    from playableenvironments_tpu_torch.cli.common import ProfileWindow

    window = ProfileWindow({"enable_profiling": True, "profile_start_step": 2, "profile_steps": 1}, str(tmp_path),
                           log_fn=lambda message: None)
    for step in range(6):
        window.before_step(step)
        torch.ones(4).sum()
        window.after_step(step + 1)
    window.close()
    traces = os.listdir(tmp_path / "profile")
    assert window.done and len(traces) == 1 and traces[0].endswith(".json")
