"""Experiment assembly from a YAML config: builders, the training loop of
phases 1 and 2, and the training and evaluation meshes.

Port of playableenvironments_tpu/cli/common.py (`load_yaml`,
`with_batching_overrides`, `build_dataset`, `build_environment_model`,
`loss_weights_from_dict`, `synthesis_training_config`, `apply_debug_flags`,
`ProfileWindow`, `output_dirs`, `build_training_mesh`, `build_eval_mesh`,
`run_synthesis_training`) and of the phase-1 and phase-3 CLIs' trainer
configurations (`autoencoder_training_config`, `playable_training_config`).
The YAML schema is the JAX package's: `data`, `model`, `playable_model`,
`training`, `playable_model_training`, `evaluation`.

Data and ray parallelism (`training.mesh: {data, rays}`) run one process a
device under torchrun (parallel/mesh.py): each process takes its slice of
the global batch, the steps run inside the mesh (batch statistics, batch-
wide loss sums and gradients over the ranks), and rank 0 logs, saves and
evaluates; every rank restores. `evaluation.mesh` splits a frame's rays
over the devices of one process (`build_eval_mesh`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

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


def require_one_device(cfg: Dict[str, Any]) -> None:
    """Raise NotImplementedError for what needs more than one device in the
    CLIs whose JAX counterparts take no mesh (train_detector,
    evaluate_reconstructed_dataset): a `training.mesh` or `evaluation.mesh`
    beyond one device, or a run of several processes (WORLD_SIZE above 1)."""
    for section in ("training", "evaluation"):
        mesh = cfg.get(section, {}).get("mesh") or {}
        if int(mesh.get("data", 1)) > 1 or int(mesh.get("rays", 1)) > 1:
            raise NotImplementedError(
                f"{section}.mesh {mesh}: this CLI runs on one device, as its JAX counterpart (which takes no mesh)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']}: this CLI runs in one process, as its JAX counterpart")


def build_training_mesh(cfg: Dict[str, Any], batch_size: int, device="cuda"):
    """The process mesh of `training.mesh: {data: N, rays: M}`, one process a
    device (parallel.mesh.create_2d_mesh / create_mesh), with the JAX
    package's validation: the mesh must span every process, the batch must
    divide over the data axis. rays > 1 splits each example's sampled rays
    over the rays axis; without the key, a data axis over every process.

    :return: (mesh, is_2d)."""
    from playableenvironments_tpu_torch.parallel import mesh as mesh_lib

    mesh_cfg = cfg.get("training", {}).get("mesh") or {}
    rays = int(mesh_cfg.get("rays", 1))
    data = int(mesh_cfg.get("data", 0))
    world = mesh_lib.world_size()
    launch = f"(launch one process a device: torchrun --nproc_per_node N; this run has {world})"
    if rays > 1:
        if data <= 0:
            data = max(world // rays, 1)
        need = data * rays
        if need > world:
            raise ValueError(f"training.mesh data={data} x rays={rays} needs {need} devices, only {world} "
                             f"available {launch}")
        if need != world:
            raise ValueError(f"the 2D mesh must span every device: data={data} x rays={rays} = {need} != {world} "
                             f"devices across {world} processes {launch}")
        if batch_size % data:
            raise ValueError(f"batch_size {batch_size} must divide over the data axis ({data}) of the 2D mesh")
        return mesh_lib.create_2d_mesh(data, device), True
    if data > 0:
        if data > world:
            raise ValueError(f"training.mesh data={data} exceeds {world} devices {launch}")
        if data < world:
            raise ValueError(f"training.mesh data={data} must use all {world} devices in a multi-process run "
                             "(or be omitted)")
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must divide over {world} devices in a multi-process run")
    return mesh_lib.create_mesh(world, device), False


def build_eval_mesh(cfg: Dict[str, Any], device="cuda"):
    """The device mesh of `evaluation.mesh: {data: N, rays: M}` for full-frame
    eval renders (the creators, play): this process renders the frame's ray
    slices on the first data x rays of its devices (every card; the CPU is
    one). None where unconfigured or rays <= 1."""
    from playableenvironments_tpu_torch.parallel import mesh as mesh_lib

    mesh_cfg = cfg.get("evaluation", {}).get("mesh") or {}
    rays = int(mesh_cfg.get("rays", 1))
    if rays <= 1:
        return None
    data = max(int(mesh_cfg.get("data", 1)), 1)
    devices = mesh_lib.local_devices(device)
    need = data * rays
    if need > len(devices):
        raise ValueError(f"evaluation.mesh data={data} x rays={rays} needs {need} devices, only {len(devices)} "
                         "available")
    return mesh_lib.create_device_mesh(devices[:need], data=data)


class QuietLogger:
    """The Logger of a rank other than 0: nothing is logged (rank 0 logs)."""

    def log(self, metrics, step):
        pass

    def print(self, message):
        pass

    def close(self):
        pass


def rank_logger(mesh, results_dir: str, run_name: str):
    """utils.logger.Logger on rank 0, a QuietLogger on the others."""
    from playableenvironments_tpu_torch.utils.logger import Logger

    return Logger(results_dir, run_name) if mesh is None or mesh.is_main else QuietLogger()


class _NanChecks:
    """torch.autograd's anomaly detection (a backward that makes a NaN
    raises at its operation) and a forward hook on every module that raises
    FloatingPointError at the first module whose output holds a NaN; both
    undone on exit."""

    def __enter__(self):
        import torch

        def check(module, inputs, output):
            stack = [output]
            while stack:
                value = stack.pop()
                if isinstance(value, (tuple, list)):
                    stack.extend(value)
                elif isinstance(value, dict):
                    stack.extend(value.values())
                elif torch.is_tensor(value) and value.is_floating_point() and bool(torch.isnan(value).any()):
                    raise FloatingPointError(f"NaN in the output of {type(module).__name__}")

        self._anomaly = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(True)
        self._hook = torch.nn.modules.module.register_module_forward_hook(check)
        return self

    def __exit__(self, *exc):
        import torch

        self._hook.remove()
        torch.autograd.set_detect_anomaly(self._anomaly)
        return False


def apply_debug_flags(cfg: Dict[str, Any]):
    """A context manager for a CLI's run: with `debug_nans: true` in
    `training`, `playable_model_training` or `autoencoder_training`, the
    operation that makes a NaN raises, in the forward pass (forward hooks
    on every module's outputs) or the backward (torch.autograd's anomaly
    detection), the reference's own mechanism and the counterpart of the
    JAX package's `jax_debug_nans`; otherwise it does nothing."""
    debug = bool(
        cfg.get("training", {}).get("debug_nans", False)
        or cfg.get("playable_model_training", {}).get("debug_nans", False)
        or cfg.get("autoencoder_training", {}).get("debug_nans", False)
    )
    return _NanChecks() if debug else contextlib.nullcontext()


class ProfileWindow:
    """One torch.profiler trace of the steps in
    [profile_start_step, profile_start_step + profile_steps), shared by the
    three training loops, written as a chrome trace under
    `<results>/profile`. Fires at most once a process (a loop whose counter
    keeps growing would otherwise start a trace again after every stop);
    `close()`, called in a `finally` after the loop, stops a trace that the
    loop's end left open."""

    def __init__(self, training_cfg: Dict[str, Any], results_dir: str, log_fn=print):
        self.enabled = bool(training_cfg.get("enable_profiling", False))
        self.start = int(training_cfg.get("profile_start_step", 10))
        self.steps = int(training_cfg.get("profile_steps", 5))
        self.out_dir = os.path.join(results_dir, "profile")
        self.log_fn = log_fn
        self.active = False
        self.done = False
        self._profiler = None

    def before_step(self, step: int):
        """Call with the counter before the step (>=, so that loops that
        advance several steps a call still enter the window)."""
        if not self.enabled or self.done or self.active:
            return
        if step >= self.start + self.steps:
            # A resume landed past the whole window.
            self.done = True
            return
        if step >= self.start:
            from playableenvironments_tpu_torch.utils.meters import start_profiler

            self._profiler = start_profiler()
            self.active = True

    def _stop(self, note: str = ""):
        from playableenvironments_tpu_torch.utils.meters import stop_profiler

        path = stop_profiler(self._profiler, self.out_dir)
        self._profiler, self.active, self.done = None, False, True
        self.log_fn(f"profiler trace written to {path}{note}")

    def after_step(self, step: int):
        """Call with the counter after the step; the trace stops (after the
        card finished the step's work) once the window is passed."""
        if self.active and step >= self.start + self.steps:
            self._stop()

    def close(self):
        if self.active:
            self._stop(" (loop exit)")


def output_dirs(cfg: Dict[str, Any]) -> Tuple[str, str]:
    """(results_dir, checkpoints_dir) of the `logging` section, created."""
    run_name = cfg.get("logging", {}).get("run_name", "run")
    results = os.path.join(cfg.get("logging", {}).get("output_root", "results"), run_name)
    checkpoints = os.path.join(cfg.get("logging", {}).get("checkpoints_root", "checkpoints"), run_name)
    os.makedirs(results, exist_ok=True)
    os.makedirs(checkpoints, exist_ok=True)
    return results, checkpoints


class RunTimes:
    """A CLI run's wall time in four parts, seconds: `startup` (from the
    CLI's start to its first step: build, dataset, model, restore, cache),
    `steps` (each step until its metrics are on the host), `saves` and
    `evaluation`, and each `steps` section's own seconds (a step, a block of
    steps or a play script). `write` puts them with the run's B1-B5
    launches into `<directory>/timing_<name>.json`."""

    def __init__(self):
        from playableenvironments_tpu_torch.utils.meters import TimeMeter

        self.started = time.perf_counter()
        self.startup = 0.0
        self.meter = TimeMeter(mode="sum")
        self.step_seconds: List[float] = []
        self.launches = _kernel_launches()

    @contextlib.contextmanager
    def section(self, name: str):
        """Time the region once: the same duration goes into the `name`
        sum and, for `steps`, into `step_seconds`, so that those sum to
        `seconds["steps"]`."""
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.meter.add(name, elapsed)
            if name == "steps":
                self.step_seconds.append(elapsed)

    def startup_done(self):
        self.startup = time.perf_counter() - self.started

    def write(self, directory: str, name: str, mesh=None) -> str:
        """Under a mesh of several processes, rank r > 0 writes
        `timing_<name>.rank<r>.json`, and each file adds the rank, the mesh
        and each step's gradient all-reduce seconds; on the card, the peak
        memory allocated (bytes)."""
        import torch

        launches = {k: v - self.launches[k] for k, v in _kernel_launches().items()}
        seconds = {"startup": self.startup, "steps": 0.0, "saves": 0.0, "evaluation": 0.0, **self.meter.summary()}
        record = {"seconds": seconds, "total": time.perf_counter() - self.started, "launches": launches,
                  "step_seconds": self.step_seconds}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            record["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        suffix = ""
        if mesh is not None and mesh.size > 1:
            record.update(rank=mesh.rank, mesh=mesh.shape, gradient_reduce_seconds=mesh.reduce_seconds)
            suffix = f".rank{mesh.rank}" if mesh.rank else ""
        path = os.path.join(directory, f"timing_{name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        return path


def _kernel_launches() -> Dict[str, int]:
    """The launch counts of every kernel wrapper (B1-B5), by wrapper."""
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.ops import fused_rollout

    return {
        "fused_adain_nerf": fused_nerf.fused_adain_nerf.launches,
        "fused_backbone_fwd": fused_nerf.fused_backbone_fwd.launches,
        "fused_backbone_bwd": fused_nerf.fused_backbone_bwd.launches,
        "backbone_f32_fwd": fused_nerf.backbone_f32_fwd.launches,
        "backbone_f32_bwd": fused_nerf.backbone_f32_bwd.launches,
        "fused_rollout_fwd": fused_rollout.fused_rollout_fwd.launches,
        "fused_rollout_bwd": fused_rollout.fused_rollout_bwd.launches,
    }


def run_training_loop(
    trainer,
    step_fn: Callable,
    epoch_batches: Callable[[int, int], Iterator],
    batches_per_epoch: int,
    section: Dict[str, Any],
    max_steps: int,
    checkpoints_dir: str,
    results_dir: str,
    logger,
    times: RunTimes,
    seed: int = 0,
    device="cuda",
    evaluate: Optional[Callable[[int], None]] = None,
    log_steps_per_sec: bool = False,
    mesh=None,
) -> None:
    """The loop of the phase-1 and phase-2 CLIs: epochs of shuffled batches
    until `max_steps`, each step drawing from `step_streams(seed, step)`;
    metrics logged every `log_interval_steps`, a checkpoint every
    `save_freq` steps and at `max_steps`, quick saves (keep 2) under
    `<checkpoints>/quick` every `quick_save_freq` steps otherwise,
    `evaluate(step)` every `eval_freq` steps, a final save.

    Under a `mesh` of several processes each step runs inside it
    (`Mesh.activate`: this rank's slice of the step's draws, the batch
    statistics and batch-wide sums over the ranks, the gradients averaged)
    on this rank's batches, its metrics averaged over the ranks; only rank 0
    logs, saves and evaluates (outside the mesh, so that no collective
    waits on it), as the JAX loop's `is_main`.

    :param step_fn: (batch, rng) -> metrics, one optimization step.
    :param epoch_batches: (epoch_seed, start) -> the epoch's batches from
        its batch `start` on. A run resumed at step s starts at epoch s //
        batches_per_epoch, batch s % batches_per_epoch, where an
        uninterrupted run would be (the JAX loops restart at the first
        batch of epoch 0), so that both take the same steps on the same
        data.
    """
    from playableenvironments_tpu_torch.train import checkpointing
    from playableenvironments_tpu_torch.utils.meters import AverageMeter, TimeMeter
    from playableenvironments_tpu_torch.utils.random import step_streams

    log_interval = int(section.get("log_interval_steps", 10))
    save_freq = int(section.get("save_freq", 30000))
    quick_save_freq = int(section.get("quick_save_freq", 500))
    eval_freq = int(section.get("eval_freq", 0))
    quick_dir = os.path.join(checkpoints_dir, "quick")
    meter, timer = AverageMeter(), TimeMeter()
    profile = ProfileWindow(section, results_dir, logger.print)
    if batches_per_epoch <= 0:
        raise ValueError("the training split holds no whole batch")
    epoch, start = divmod(trainer.step, batches_per_epoch)
    is_main = mesh is None or mesh.is_main
    times.startup_done()
    try:
        while trainer.step < max_steps:
            for batch in epoch_batches(seed + epoch, start):
                profile.before_step(trainer.step)
                with times.section("steps"), timer.section("step"):
                    rng = step_streams(seed, trainer.step, device=device)
                    if mesh is None:
                        metrics = step_fn(batch, rng)
                    else:
                        with mesh.activate():
                            metrics = mesh.mean_metrics(step_fn(batch, mesh.streams(rng)))
                    meter.add({k: float(v) for k, v in metrics.items()})
                step = trainer.step
                profile.after_step(step)
                if step % log_interval == 0:
                    logged = meter.pop_all()
                    if log_steps_per_sec:
                        logged["steps_per_sec"] = 1.0 / max(timer.summary().get("step", 1), 1e-9)
                    logger.log(logged, step)
                with times.section("saves"):
                    if not is_main:
                        pass
                    elif step % save_freq == 0 or step >= max_steps:
                        checkpointing.save_checkpoint(checkpoints_dir, trainer)
                    elif step % quick_save_freq == 0:
                        checkpointing.save_checkpoint(quick_dir, trainer, keep=2)
                if evaluate is not None and eval_freq and step % eval_freq == 0 and is_main:
                    with times.section("evaluation"):
                        evaluate(step)
                if step >= max_steps:
                    break
            epoch, start = epoch + 1, 0
    finally:
        profile.close()
    if is_main:
        with times.section("saves"):
            checkpointing.save_checkpoint(checkpoints_dir, trainer)


def resume_or_graft(trainer, checkpoints_dir: str, logger, autoencoder_checkpoint: str = "") -> Optional[str]:
    """Restore `trainer` from the newest of `<checkpoints>` and
    `<checkpoints>/quick`; without one, graft the phase-1 checkpoint
    `autoencoder_checkpoint` (a config's `model.autoencoder.weights_filename`,
    unless empty or "untrained_model") into the phase-2 model.
    :return: the checkpoint resumed from, or None."""
    from playableenvironments_tpu_torch.train import checkpointing

    resume_from = checkpointing.latest_checkpoint_any(checkpoints_dir, os.path.join(checkpoints_dir, "quick"))
    if resume_from:
        checkpointing.restore_checkpoint(resume_from, trainer)
        logger.print(f"resumed from {resume_from} at step {trainer.step}")
    elif autoencoder_checkpoint and autoencoder_checkpoint != "untrained_model":
        checkpointing.graft_autoencoder(autoencoder_checkpoint, trainer.model)
        logger.print(f"autoencoder warm-started from {autoencoder_checkpoint}")
    return resume_from


def run_synthesis_training(cfg: Dict[str, Any], max_steps_override: Optional[int] = None, seed: int = 0,
                           device="cuda", times: Optional[RunTimes] = None) -> str:
    """The phase-2 training loop (run_training_loop) on `device`: the
    model seeded from `seed`, resumed from the latest checkpoint or warm
    started from `model.autoencoder.weights_filename`; with
    `training.eval_freq`, a TrainingEvaluator renders the first batch of
    the `val` split (the training split where there is none). Over several
    processes (`build_training_mesh`), each takes its interleaved slice of
    every epoch's global order (dataset.iterate_batches' process_index),
    the state is broadcast from rank 0 after the restore, and each step's
    rays split over `training.mesh.rays`.
    :return: the checkpoints directory."""
    from playableenvironments_tpu_torch.parallel import mesh as mesh_lib
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer

    times = times or RunTimes()
    results_dir, checkpoints_dir = output_dirs(cfg)
    batch_size = int(cfg["training"]["batching"].get("batch_size", 8))
    mesh, mesh_is_2d = build_training_mesh(cfg, batch_size, device)
    if mesh_is_2d:
        # The default of synthesis_training_config's samples_per_image: an
        # omitted key is validated against the rays axis too.
        samples = int(cfg["training"].get("samples_per_image", 144))
        if samples % mesh.rays:
            raise ValueError(f"training.samples_per_image {samples} must divide over the rays axis ({mesh.rays}) "
                             "of the 2D mesh")
    logger = rank_logger(mesh, results_dir, cfg.get("logging", {}).get("run_name", "run"))
    model = build_environment_model(cfg, device=device, seed=seed)
    train_cfg = synthesis_training_config(cfg)
    if max_steps_override:
        train_cfg = dataclasses.replace(train_cfg, max_steps=max_steps_override)
    trainer = SynthesisTrainer(model, train_cfg)
    dataset = build_dataset(cfg, "train")
    local_batch = batch_size // mesh.data
    resume_or_graft(trainer, checkpoints_dir, logger,
                    cfg.get("model", {}).get("autoencoder", {}).get("weights_filename", ""))
    mesh_lib.replicate(model, mesh)
    mesh_lib.compile_barrier(trainer.train_step)

    evaluate = None
    if int(cfg["training"].get("eval_freq", 0)):
        from playableenvironments_tpu_torch.eval.training_evaluator import TrainingEvaluator

        try:
            val_dataset = build_dataset(cfg, "val")
        except FileNotFoundError:
            val_dataset = dataset
        eval_batch = next(val_dataset.iterate_batches(1, shuffle=False))
        evaluator = TrainingEvaluator(
            model, tuple(eval_batch.observations.shape[-3:-1]),
            patch_strides=train_cfg.patch_strides if model.scene.autoencoder is not None else None,
        )

        def evaluate(step):
            evaluator.evaluate(eval_batch, logger, step)

    def epoch_batches(epoch_seed, start):
        return dataset.iterate_batches(local_batch, seed=epoch_seed, start=start, process_index=mesh.data_index,
                                       process_count=mesh.data)

    run_training_loop(
        trainer, lambda batch, rng: trainer.train_step(batch.to(device), rng), epoch_batches,
        (len(dataset) // mesh.data) // local_batch, cfg["training"], train_cfg.max_steps, checkpoints_dir,
        results_dir, logger, times, seed=seed, device=device, evaluate=evaluate, log_steps_per_sec=True,
        mesh=mesh if mesh.size > 1 else None,
    )
    times.write(results_dir, "train", mesh)
    logger.close()
    return checkpoints_dir
