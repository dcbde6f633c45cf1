"""Experiment assembly from a YAML config: the dataset and model builders.

Port of the builders of playableenvironments_tpu/cli/common.py
(`load_yaml`, `with_batching_overrides`, `build_dataset`,
`build_environment_model`, `loss_weights_from_dict`,
`synthesis_training_config`) and of the phase-1 and phase-3 CLIs' trainer
configurations (`autoencoder_training_config`, `playable_training_config`). The YAML schema is the JAX package's: `data`,
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
    get a table of `model.camera_parameters_memory_size` frames and one
    column per camera of `training.batching.allowed_cameras`."""
    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel

    scene = config_lib.scene_from_dict(cfg["model"], cfg.get("playable_model"))
    training_cameras = cfg.get("training", {}).get("batching", {}).get("allowed_cameras")
    return EnvironmentModel(
        scene,
        focal_length_multiplier=float(cfg.get("data", {}).get("focal_length_multiplier", 1.0)),
        enable_camera_offsets=bool(cfg.get("model", {}).get("enable_camera_parameters_offsets", False)),
        camera_memory_size=int(cfg.get("model", {}).get("camera_parameters_memory_size", 1)),
        training_cameras_count=len(training_cameras) if training_cameras else 1,
        device=device,
        seed=seed,
    )


def playable_training_config(cfg: Dict[str, Any]):
    """train.trainer_playable.PlayableTrainingConfig of
    `cfg["playable_model_training"]`, read as the JAX phase-3 CLI reads it
    (cli/train_playable.py); the discriminators are wanted where its
    `gan` weight is above 0."""
    from playableenvironments_tpu_torch.train.trainer_playable import (
        PlayableLossWeights,
        PlayableTrainingConfig,
    )

    t = cfg["playable_model_training"]
    w = t.get("loss_weights", {})
    batching = t.get("batching", {})
    return PlayableTrainingConfig(
        learning_rate=float(t.get("learning_rate", 5e-4)),
        lr_gamma=float(t.get("lr_gamma", 0.926118)),
        lr_decay_iterations=int(t.get("lr_decay_iterations", 10000)),
        weight_decay=float(t.get("weight_decay", 0.0)),
        max_steps=int(t.get("max_steps", 300000)),
        ground_truth_observations_start=int(t.get("ground_truth_observations_start", 6)),
        ground_truth_observations_end=int(t.get("ground_truth_observations_end", 6)),
        ground_truth_observations_steps=int(t.get("ground_truth_observations_steps", 16000)),
        observations_count=int(batching.get("observations_count", 9)),
        observations_count_start=int(batching.get("observations_count_start", batching.get("observations_count", 9))),
        observations_count_steps=int(batching.get("observations_count_steps", 25000)),
        mutual_information_alpha=float(t.get("mutual_information_estimation_alpha", 0.2)),
        mutual_information_entropy_lambda=float(t.get("mutual_information_entropy_lambda", 1.0)),
        betas=tuple(float(b) for b in t.get("betas", (0.9, 0.999))),
        discriminator_learning_rate=(
            float(t["discriminator_learning_rate"]) if "discriminator_learning_rate" in t else None
        ),
        discriminator_weight_decay=(
            float(t["discriminator_weight_decay"]) if "discriminator_weight_decay" in t else None
        ),
        use_camera_relative_acmv=bool(t.get("use_camera_relative_acmv", False)),
        acmv_rotation_axis=t.get("acmv_rotation_axis"),
        loss_weights=PlayableLossWeights(
            rotations_rec=float(w.get("rotations_rec_lambda", 1.0)),
            translations_rec=float(w.get("translations_rec_lambda", 1.0)),
            style_rec=float(w.get("style_rec_lambda", 1.0)),
            deformation_rec=float(w.get("deformation_rec_lambda", 1.0)),
            entropy=float(w.get("entropy_lambda", 0.0)),
            action_directions_kl=float(w.get("action_directions_kl_lambda", 1e-4)),
            action_mutual_information=float(w.get("action_mutual_information_lambda", 0.15)),
            acmv=float(w.get("acmv_lambda", 0.0)),
            gan=float(w.get("gan_lambda", 0.0)),
        ),
    )


def loss_weights_from_dict(d: Dict[str, Any]):
    """train.trainer_synthesis.LossWeights of a `training.loss_weights`
    section."""
    from playableenvironments_tpu_torch.train.trainer_synthesis import LossWeights

    return LossWeights(
        reconstruction=float(d.get("reconstruction_loss_lambda", 1.0)),
        perceptual=float(d.get("perceptual_loss_lambda", 0.0)),
        ray_object_distance=float(d.get("ray_object_distance_loss_lambda", 0.0)),
        bounding_box=float(d.get("bounding_box_loss_lambda", 0.0)),
        displacements_magnitude=float(d.get("displacements_magnitude_loss_lambda", 0.0)),
        divergence=float(d.get("divergence_loss_lambda", 0.0)),
        opacity=float(d.get("opacity_loss_lambda", 0.0)),
        attention=float(d.get("attention_loss_lambda", 0.0)),
        sharpness=float(d.get("sharpness_loss_lambda", 0.0)),
        sharpness_mean=float(d.get("sharpness_loss_mean", 0.5)),
        sharpness_std=float(d.get("sharpness_loss_std", 0.15)),
    )


def synthesis_training_config(cfg: Dict[str, Any]):
    """train.trainer_synthesis.SynthesisTrainingConfig of `cfg["training"]`:
    with a `model.autoencoder`, the patch strides are the autoencoder's and
    a `patch_size` above 0 selects the decoder path."""
    from playableenvironments_tpu_torch.models.autoencoder import autoencoder_strides
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainingConfig

    t = cfg["training"]
    has_ae = "autoencoder" in cfg.get("model", {})
    strides = ()
    if has_ae:
        scene = config_lib.scene_from_dict(cfg["model"], cfg.get("playable_model"))
        strides = tuple(autoencoder_strides(scene.autoencoder))
    return SynthesisTrainingConfig(
        learning_rate=float(t.get("learning_rate", 5e-4)),
        lr_gamma=float(t.get("lr_gamma", 0.926118)),
        lr_decay_iterations=int(t.get("lr_decay_iterations", 10000)),
        weight_decay=float(t.get("weight_decay", 0.0)),
        max_steps=int(t.get("max_steps", 300000)),
        samples_per_image=int(t.get("samples_per_image", 144)),
        perturb=bool(t.get("perturb", True)),
        shuffle_style=bool(t.get("shuffle_style", True)),
        patch_size=int(t.get("patch_size", 0)),
        patch_strides=strides,
        loss_weights=loss_weights_from_dict(t.get("loss_weights", {})),
        decode_patches=has_ae and int(t.get("patch_size", 0)) > 0,
        crop_to_patch=bool(t.get("crop_to_patch", True)),
        autoencoder_learning_rate=float(t.get("autoencoder_learning_rate", 1e-4)),
        frozen_autoencoder_steps=int(t.get("frozen_autoencoder_steps", 0)),
        camera_parameters_learning_rate=float(t.get("camera_parameters_learning_rate", 0.0)),
        remat=bool(t.get("remat", False)),
    )


def autoencoder_training_config(cfg: Dict[str, Any]):
    """train.trainer_autoencoder.AutoencoderTrainingConfig of the
    `autoencoder_training` section, or of `training` where there is none,
    read as the JAX phase-1 CLI reads it."""
    from playableenvironments_tpu_torch.train.trainer_autoencoder import AutoencoderTrainingConfig

    t = cfg.get("autoencoder_training") or cfg["training"]
    w = t.get("loss_weights", {})
    return AutoencoderTrainingConfig(
        learning_rate=float(t.get("learning_rate", 4e-4)),
        lr_gamma=float(t.get("lr_gamma", 0.926118)),
        lr_decay_iterations=int(t.get("lr_decay_iterations", 10000)),
        max_steps=int(t.get("max_steps", 300000)),
        kl_lambda=float(w.get("KL_loss_lambda", 5e-6)),
        perceptual_lambda=float(w.get("perceptual_loss_lambda", 0.0)),
        vgg_weights_path=str(t.get("vgg_weights_path", "")),
        remat=bool(t.get("remat", False)),
    )
