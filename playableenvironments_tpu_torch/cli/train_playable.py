"""Phase-3 action-module training entry point.

Port of playableenvironments_tpu/cli/train_playable.py:

    python -m playableenvironments_tpu_torch.cli.train_playable --config <yaml> \
        --environment_checkpoint <phase-2 checkpoint> [--device cuda|cpu]

The phase-2 checkpoint's environment model is restored (restore_params) and
frozen; every frame of the training split is encoded once into the
encoding cache `<checkpoints>/<run>/playable/encoding_cache.npz`, reloaded
when its fingerprint matches the frozen weights and rebuilt otherwise; the
animation models (and, with a GAN weight, the discriminators) train on
cached encodings with sequence-length annealing. Checkpoints go under
`<checkpoints>/<run>/playable`, a run resumes from the newest of them and
its `quick` subdirectory.

The loop keeps the JAX loop's `steps_per_call` blocks as a Python loop over
the block's steps: the block's metrics are averaged into the meter; logging,
saves, quick saves and evaluation run when the block crosses their interval;
a change of the annealed sequence length ends the epoch after the block; an
epoch's remainder of fewer batches than a block runs as single steps. A
block's steps draw from step_streams(seed, step before the block, index),
a single step from step_streams(seed, step). The last block can carry the
step count past `max_steps`, as the JAX loop's does. `eval_freq` runs the
PlayableModelEvaluator. Runs on the card by default; without one it raises
unless `--device cpu`. Over several processes (torchrun, as cli/train.py)
the batch splits over a data axis of every process: rank 0 builds the
encoding cache while the others wait and then load it, each rank takes its
interleaved slice of every epoch's windows, each step runs inside the mesh
(its draws, batch statistics, batch-wide loss sums and gradients those of
the global batch), and rank 0 logs, saves and evaluates.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def crossed(before: int, after: int, freq: int) -> bool:
    """Whether the steps (before, after] include a multiple of `freq`."""
    return freq > 0 and (before // freq) != (after // freq)


def main():
    parser = argparse.ArgumentParser(description="Phase-3 playable-model training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--environment_checkpoint", default=None, help="phase-2 checkpoint path")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.common import (
        ProfileWindow, RunTimes, apply_debug_flags, build_dataset, build_environment_model, load_yaml,
        output_dirs, playable_training_config, rank_logger,
    )
    from playableenvironments_tpu_torch.parallel import mesh as mesh_lib
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train import checkpointing
    from playableenvironments_tpu_torch.train.encoding_cache import EncodingCache, params_fingerprint
    from playableenvironments_tpu_torch.train.trainer_playable import PlayableTrainer
    from playableenvironments_tpu_torch.utils.device import resolve_device
    from playableenvironments_tpu_torch.utils.meters import AverageMeter
    from playableenvironments_tpu_torch.utils.random import step_streams

    times = RunTimes()
    device = resolve_device(args.device)
    cfg = load_yaml(args.config)
    if args.environment_checkpoint is None:
        raise SystemExit("--environment_checkpoint is required")
    with mesh_lib.process_group(device), apply_debug_flags(cfg):
        results_dir, checkpoints_dir = output_dirs(cfg)
        # Phase 3 keeps its checkpoints apart from phase 2's of the same run.
        checkpoints_dir = os.path.join(checkpoints_dir, "playable")
        quick_dir = os.path.join(checkpoints_dir, "quick")
        os.makedirs(checkpoints_dir, exist_ok=True)
        # A data axis over every process (the JAX CLI's create_mesh()).
        mesh = mesh_lib.create_mesh(device=device)
        logger = rank_logger(mesh, results_dir, cfg.get("logging", {}).get("run_name", "playable"))

        env_model = build_environment_model(cfg, device=device, seed=args.seed)
        checkpointing.restore_params(args.environment_checkpoint, env_model)
        t = cfg["playable_model_training"]
        batching = t.get("batching", {})
        train_cfg = playable_training_config(cfg)
        if args.max_steps:
            train_cfg = dataclasses.replace(train_cfg, max_steps=args.max_steps)
        playable = PlayableEnvironmentModel(env_model.scene, with_discriminators=train_cfg.loss_weights.gan > 0.0,
                                            device=device, seed=args.seed)
        trainer = PlayableTrainer(playable, train_cfg, environment_model=env_model)
        trainer.init_extra(args.seed)

        dataset = build_dataset({**cfg, "training": {"batching": batching}}, "train")
        batch_size = int(batching.get("batch_size", 16))
        if batch_size % mesh.data:
            raise ValueError(f"batch_size {batch_size} must divide over {mesh.data} devices")
        local_batch = batch_size // mesh.data
        dataset.set_observations_count(train_cfg.observations_count_at(0))

        resume_from = checkpointing.latest_checkpoint_any(checkpoints_dir, quick_dir)
        if resume_from:
            checkpointing.restore_checkpoint(resume_from, trainer)
            logger.print(f"resumed from {resume_from}")
        mesh_lib.replicate([playable, trainer.centroids, trainer.mi_matrices], mesh)

        # The frozen encoding is deterministic (eval mode): every frame is
        # encoded once and phase 3 trains on the cached state vectors.
        cache_path = os.path.join(checkpoints_dir, "encoding_cache.npz")
        fingerprint = params_fingerprint(env_model)
        cache = None
        if mesh.is_main and os.path.exists(cache_path):
            try:
                cache = EncodingCache.load(cache_path, fingerprint=fingerprint)
                logger.print(f"loaded encoding cache from {cache_path}")
            except ValueError as stale:
                logger.print(f"{stale}; rebuilding")
        if mesh.is_main and cache is None:
            cache = EncodingCache.build(trainer.encode_batch, dataset,
                                        batch_size=int(t.get("encoding_batch_size", 32)), log_fn=logger.print)
            cache.save(cache_path, fingerprint=fingerprint)
            logger.print(f"built encoding cache {cache_path}")
        # Rank 0 builds the cache (the dominant startup cost); the others
        # wait for it and load what it saved.
        mesh_lib.barrier(device)
        if cache is None:
            cache = EncodingCache.load(cache_path, fingerprint=fingerprint)

        steps_per_call = max(int(t.get("steps_per_call", 8)), 1)
        meter = AverageMeter()
        log_interval = int(t.get("log_interval_steps", 10))
        save_freq = int(t.get("save_freq", 10000))
        quick_save_freq = int(t.get("quick_save_freq", 500))
        eval_freq = int(t.get("eval_freq", 0))
        evaluator = None
        if eval_freq:
            from playableenvironments_tpu_torch.eval.playable_evaluator import build_playable_evaluator

            evaluator = build_playable_evaluator(cfg, trainer, dataset, results_dir, seed=args.seed)

        def housekeeping(before: int) -> int:
            """Logging, checkpoints and evaluation whose interval the steps
            (before, now] crossed."""
            step = trainer.step
            if crossed(before, step, log_interval):
                logger.log(meter.pop_all(), step)
            with times.section("saves"):
                if not mesh.is_main:
                    pass
                elif crossed(before, step, save_freq) or step >= train_cfg.max_steps:
                    checkpointing.save_checkpoint(checkpoints_dir, trainer)
                elif crossed(before, step, quick_save_freq):
                    checkpointing.save_checkpoint(quick_dir, trainer, keep=2)
            if evaluator is not None and crossed(before, step, eval_freq) and mesh.is_main:
                with times.section("evaluation"):
                    evaluator.evaluate(logger, step)
            return step

        def run_steps(encodings, before: int, block: bool):
            """The steps of one block (or one single step), their metrics'
            means into the meter."""
            with times.section("steps"):
                sums = {}
                for index, encoding in enumerate(encodings):
                    rng = (step_streams(args.seed, before, index, device=device) if block
                           else step_streams(args.seed, before, device=device))
                    with mesh.activate():
                        metrics = mesh.mean_metrics(trainer.fused_step(encoding, mesh.streams(rng)))
                    for name, value in metrics.items():
                        sums[name] = sums.get(name, 0.0) + float(value)
                meter.add({name: value / len(encodings) for name, value in sums.items()})

        profile = ProfileWindow(t, results_dir, logger.print)

        def maybe_profile(before: int):
            # Called after each block: the trace starts and stops on
            # different calls.
            if not profile.active:
                profile.before_step(before)
            else:
                profile.after_step(trainer.step)

        times.startup_done()
        epoch = 0
        try:
            while trainer.step < train_cfg.max_steps:
                current_length = train_cfg.observations_count_at(trainer.step)
                pending = []
                stop_epoch = False
                for encoding in cache.iterate_encoding_batches(local_batch, current_length, seed=args.seed + epoch,
                                                               process_index=mesh.data_index,
                                                               process_count=mesh.data, device=device):
                    pending.append(encoding)
                    if len(pending) < steps_per_call:
                        continue
                    before = trainer.step
                    run_steps(pending, before, block=True)
                    pending = []
                    maybe_profile(before)
                    step = housekeeping(before)
                    if step >= train_cfg.max_steps or train_cfg.observations_count_at(step) != current_length:
                        stop_epoch = True
                        break
                # The epoch's remainder (fewer batches than a block): single steps.
                for encoding in ([] if stop_epoch else pending):
                    before = trainer.step
                    run_steps([encoding], before, block=False)
                    maybe_profile(before)
                    if housekeeping(before) >= train_cfg.max_steps:
                        break
                epoch += 1
        finally:
            profile.close()
        if mesh.is_main:
            with times.section("saves"):
                checkpointing.save_checkpoint(checkpoints_dir, trainer)
        times.write(results_dir, "train_playable", mesh)
        logger.close()
    print(f"playable training complete; checkpoints in {checkpoints_dir}")


if __name__ == "__main__":
    main()
