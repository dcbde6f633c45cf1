"""Checkpoints of the three trainers, and the transfers between phases.

Port of playableenvironments_tpu/train/checkpointing.py with torch files in
place of orbax: `save_checkpoint` writes `<directory>/checkpoint_<step>/`
holding one `torch.save` file (`STATE_FILE`) of tensors and plain values,
read back with `torch.load(..., weights_only=True)` onto the trainer's
device. A trainer's whole state:

- phase 1 (AutoencoderTrainer): the autoencoder's parameters and buffers,
  its Adam state, the step;
- phase 2 (SynthesisTrainer): the environment model's parameters and
  buffers (batch norms, camera offsets), its Adam state with every rate
  group, the step;
- phase 3 (PlayableTrainer): the generator's and discriminators'
  parameters and buffers, both Adam states and step counts, and the
  per-animation-model `centroids` and `mi_matrices` (the JAX TrainState's
  `extra`);
- the player detector (DetectorTrainer): the detector's parameters and
  batch statistics, its AdamW state, the step.

Every load is strict: each entry of the file is consumed and every shape
checked, or it raises ValueError. The transfers between phases, as the
published pipeline chains them: `graft_autoencoder` (phase 1's autoencoder
into the phase-2 model), `restore_params` (a checkpoint's model into a
fresh module: phase 2's environment model for phase 3 and play, phase 3's
playable model for play), and `latest_checkpoint_any` for a run that
resumes.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

STATE_FILE = "state.pt"
PREFIX = "checkpoint_"


def _kind(trainer) -> str:
    kinds = {"AutoencoderTrainer": "autoencoder", "SynthesisTrainer": "synthesis", "PlayableTrainer": "playable",
             "DetectorTrainer": "detector"}
    name = type(trainer).__name__
    if name not in kinds:
        raise TypeError(f"no checkpoint layout for {name}")
    return kinds[name]


def _trainer_model(trainer) -> nn.Module:
    return trainer.playable_model if _kind(trainer) == "playable" else trainer.model


def _optimizers(trainer) -> Dict[str, object]:
    optimizers = {"optimizer": trainer.optimizer}
    if _kind(trainer) == "playable" and trainer.discriminator_optimizer is not None:
        optimizers["discriminator_optimizer"] = trainer.discriminator_optimizer
    return optimizers


def _optimizer_state(optimizer) -> dict:
    return {"adam": optimizer.optimizer.state_dict(), "step_count": optimizer.step_count}


def _load_optimizer(label: str, optimizer, state: dict) -> None:
    """Adam's state, strictly: the same groups of the same sizes, and every
    moment of its parameter's shape."""
    if set(state) != {"adam", "step_count"}:
        raise ValueError(f"{label}: entries {sorted(state)}, expected adam and step_count")
    adam = state["adam"]
    groups = optimizer.optimizer.param_groups
    saved = adam["param_groups"]
    if [(g["name"], len(g["params"])) for g in groups] != [(g.get("name"), len(g["params"])) for g in saved]:
        raise ValueError(f"{label}: rate groups {[(g.get('name'), len(g['params'])) for g in saved]} do not match "
                         f"{[(g['name'], len(g['params'])) for g in groups]}")
    params = [p for g in groups for p in g["params"]]
    ids = [i for g in saved for i in g["params"]]
    for index, param in zip(ids, params):
        for key, value in adam["state"].get(index, {}).items():
            if key != "step" and tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{label}: {key} of parameter {index} has shape {tuple(value.shape)}, "
                                 f"the parameter {tuple(param.shape)}")
    if set(adam["state"]) - set(ids):
        raise ValueError(f"{label}: state for parameters {sorted(set(adam['state']) - set(ids))} it does not have")
    optimizer.optimizer.load_state_dict(adam)
    optimizer.step_count = int(state["step_count"])


def _load_module(label: str, module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """A state_dict into `module`, strictly: the same names, the same shapes."""
    own = module.state_dict()
    missing, unknown = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if missing or unknown:
        raise ValueError(f"{label}: missing {missing[:5]}, unknown {unknown[:5]} "
                         f"({len(missing)} missing, {len(unknown)} unknown)")
    for name, value in state.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{label}: {name} has shape {tuple(value.shape)}, the module {tuple(own[name].shape)}")
    module.load_state_dict(state)


def trainer_state(trainer) -> dict:
    """The trainer's whole state as tensors and plain values (references to
    the live tensors: `torch.save` copies them)."""
    state = {"kind": _kind(trainer), "step": trainer.step, "model": _trainer_model(trainer).state_dict()}
    for name, optimizer in _optimizers(trainer).items():
        state[name] = _optimizer_state(optimizer)
    if state["kind"] == "playable":
        state["centroids"] = list(trainer.centroids)
        state["mi_matrices"] = list(trainer.mi_matrices)
    return state


def _flatten(state: dict) -> Dict[Tuple[str, ...], object]:
    """A nested state flattened by path (a tuple of keys and list indexes):
    a copy of every tensor, and the plain values."""
    out = {}

    def walk(value, path):
        if isinstance(value, dict):
            for key, item in value.items():
                walk(item, path + (str(key),))
        elif isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                walk(item, path + (str(i),))
        else:
            out[path] = value.detach().clone() if torch.is_tensor(value) else value

    walk(state, ())
    return out


def flat_state(trainer) -> Dict[Tuple[str, ...], object]:
    """trainer_state flattened by path (`_flatten`)."""
    return _flatten(trainer_state(trainer))


def saved_flat_state(path: str) -> Dict[Tuple[str, ...], object]:
    """A saved checkpoint's state flattened as flat_state flattens a
    trainer's, on the CPU, without a trainer to restore it into."""
    return _flatten(_read(path, "cpu"))


def state_difference(got: Dict[tuple, object], ref: Dict[tuple, object]) -> Optional[str]:
    """None when two flat states (flat_state's form) hold the same entries,
    every tensor of the same dtype and equal bit for bit; else the first
    difference, described."""
    if set(got) != set(ref):
        return f"entries differ: {sorted(set(got) ^ set(ref))[:5]}"
    for path, value in ref.items():
        if torch.is_tensor(value):
            if not (got[path].dtype == value.dtype and torch.equal(got[path].to(value.device), value)):
                return f"{'.'.join(path)} differs"
        elif got[path] != value:
            return f"{'.'.join(path)} is {got[path]!r}, saved {value!r}"
    return None


def _device(module: nn.Module) -> torch.device:
    return next(iter(module.state_dict().values())).device


def _read(path: str, device) -> dict:
    return torch.load(os.path.join(path, STATE_FILE), weights_only=True, map_location=device)


def _checkpoints(directory: str) -> List[Tuple[int, str]]:
    """(step, name) of every `checkpoint_<step>` in `directory` whose step
    parses (a save in progress, `checkpoint_<step>.tmp`, does not)."""
    entries = []
    for name in os.listdir(directory):
        if name.startswith(PREFIX):
            try:
                entries.append((int(name.split("_")[-1]), name))
            except ValueError:
                continue
    return entries


def save_checkpoint(directory: str, trainer, step: Optional[int] = None, keep: Optional[int] = None) -> str:
    """Write `<directory>/checkpoint_<step>/` (step defaults to the
    trainer's), replacing one of that name; with `keep`, then prune the
    directory to its newest `keep` checkpoints. The state is written into
    `checkpoint_<step>.tmp/` and the directory renamed when complete, so a
    save cut short leaves the newest complete checkpoint the latest.
    :return: the absolute path."""
    step = trainer.step if step is None else step
    path = os.path.join(os.path.abspath(directory), f"{PREFIX}{step}")
    temporary = path + ".tmp"
    shutil.rmtree(temporary, ignore_errors=True)
    os.makedirs(temporary)
    torch.save(trainer_state(trainer), os.path.join(temporary, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(temporary, path)
    if keep:
        for _, name in sorted(_checkpoints(directory))[:-keep]:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The absolute path of the newest `checkpoint_<step>` in `directory`
    (names whose step does not parse are skipped), or None."""
    if not os.path.isdir(directory):
        return None
    candidates = _checkpoints(directory)
    if not candidates:
        return None
    return os.path.abspath(os.path.join(directory, max(candidates)[1]))


def checkpoint_step(path: Optional[str]) -> int:
    """The step in a `checkpoint_<step>` path (-1 for None or a name that
    does not parse)."""
    if not path:
        return -1
    try:
        return int(path.rsplit("_", 1)[-1])
    except ValueError:
        return -1


def latest_checkpoint_any(*directories: str) -> Optional[str]:
    """The newest checkpoint (by step) across several directories, or None."""
    candidates = [latest_checkpoint(d) for d in directories]
    best = max(candidates, key=checkpoint_step, default=None)
    return best if checkpoint_step(best) >= 0 else None


def restore_checkpoint(path: str, trainer):
    """Restore a trainer's whole state saved by save_checkpoint, in place,
    onto the trainer's device. :return: the trainer."""
    kind = _kind(trainer)
    model = _trainer_model(trainer)
    state = _read(path, _device(model))
    expected = {"kind", "step", "model"} | set(_optimizers(trainer))
    if kind == "playable":
        expected |= {"centroids", "mi_matrices"}
    if state.get("kind") != kind:
        raise ValueError(f"{path} holds a {state.get('kind')} state, the trainer is {kind}")
    if set(state) != expected:
        raise ValueError(f"{path}: entries {sorted(state)}, expected {sorted(expected)}")
    _load_module(f"{path} model", model, state["model"])
    for name, optimizer in _optimizers(trainer).items():
        _load_optimizer(f"{path} {name}", optimizer, state[name])
    if kind == "playable":
        counts = len(trainer.scene_animation_configs())
        for name in ("centroids", "mi_matrices"):
            if len(state[name]) != counts:
                raise ValueError(f"{path}: {len(state[name])} {name}, the trainer has {counts} animation models")
        trainer.centroids = list(state["centroids"])
        trainer.mi_matrices = list(state["mi_matrices"])
    if trainer.step != state["step"]:
        raise ValueError(f"{path}: step {state['step']}, the optimizer's count {trainer.step}")
    return trainer


def has_discriminators(path: str) -> bool:
    """Whether a phase-3 checkpoint holds discriminators (a run with a GAN
    weight), which the playable model that restores it must have too."""
    state = torch.load(os.path.join(path, STATE_FILE), weights_only=True, map_location="cpu")
    if state.get("kind") != "playable":
        raise ValueError(f"{path} holds a {state.get('kind')} state, not phase 3's")
    return "discriminator_optimizer" in state


def restore_params(path: str, module: nn.Module) -> nn.Module:
    """Only a checkpoint's model (parameters and buffers) into a fresh
    `module` of the same architecture, strictly: the transfer from one
    phase to the next. :return: the module."""
    state = _read(path, _device(module))
    _load_module(f"{path} model", module, state["model"])
    return module


def graft_autoencoder(path: str, model: nn.Module) -> nn.Module:
    """A phase-1 checkpoint's MultiresAutoencoder (encoder and decoder,
    parameters and running statistics) into the phase-2 model's
    `autoencoder`, strictly. Raises ValueError when the model has none.
    :return: the model."""
    if not hasattr(model, "autoencoder"):
        raise ValueError("graft_autoencoder: the phase-2 model has no autoencoder submodule "
                         "(model.autoencoder missing from the config?)")
    state = _read(path, _device(model))
    if state.get("kind") != "autoencoder":
        raise ValueError(f"graft_autoencoder: {path} holds a {state.get('kind')} state, not phase 1's")
    _load_module(f"{path} autoencoder", model.autoencoder, state["model"])
    return model
