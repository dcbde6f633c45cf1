"""Experiment assembly from a YAML config: the dataset and model builders.

Port of the builders of playableenvironments_tpu/cli/common.py
(`load_yaml`, `with_batching_overrides`, `build_dataset`,
`build_environment_model`). The YAML schema is the JAX package's: `data`,
`model`, `playable_model`, `training`, `playable_model_training`,
`evaluation`. The meshes and training runners come with the CLIs.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from playableenvironments_tpu_torch import config as config_lib
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset


load_yaml = config_lib.load_config


def with_batching_overrides(cfg: Dict[str, Any], **overrides) -> Dict[str, Any]:
    """cfg with individual `training.batching` keys overridden, keeping the
    rest of the section (allowed_cameras, observation_stacking, ...)."""
    training = dict(cfg.get("training", {}))
    batching = dict(training.get("batching", {}))
    batching.update(overrides)
    training["batching"] = batching
    return {**cfg, "training": training}


def build_dataset(cfg: Dict[str, Any], split: str, batching_key: str = "batching") -> MulticameraVideoDataset:
    """The `split` directory under `data.data_root`, windowed by
    `training.<batching_key>` and resized to `data.target_input_size`
    (given as (width, height))."""
    data_cfg = cfg["data"]
    batching = cfg.get("training", {}).get(batching_key, {})
    target = data_cfg.get("target_input_size")
    target_size = (int(target[1]), int(target[0])) if target else None  # (h, w)
    return MulticameraVideoDataset(
        os.path.join(data_cfg["data_root"], split),
        observations_count=int(batching.get("observations_count", 1)),
        skip_frames=int(batching.get("skip_frames", 0)),
        observation_stacking=int(batching.get("observation_stacking", 1)),
        allowed_cameras=batching.get("allowed_cameras"),
        target_size=target_size,
    )


def build_environment_model(cfg: Dict[str, Any], device="cuda", seed: int = 0):
    """render.environment_model.EnvironmentModel of `cfg["model"]` on
    `device` with seeded weights (compat.from_flax loads trained ones).
    Per-frame camera offsets (`model.enable_camera_parameters_offsets`)
    raise NotImplementedError there."""
    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel

    scene = config_lib.scene_from_dict(cfg["model"], cfg.get("playable_model"))
    return EnvironmentModel(
        scene,
        focal_length_multiplier=float(cfg.get("data", {}).get("focal_length_multiplier", 1.0)),
        enable_camera_offsets=bool(cfg.get("model", {}).get("enable_camera_parameters_offsets", False)),
        device=device,
        seed=seed,
    )
