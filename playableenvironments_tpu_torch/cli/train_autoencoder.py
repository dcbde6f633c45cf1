"""Phase-1 feature-renderer (VAE) training entry point.

Port of playableenvironments_tpu/cli/train_autoencoder.py:

    python -m playableenvironments_tpu_torch.cli.train_autoencoder --config <yaml> [--device cuda|cpu]

The `autoencoder_training:` block of the published configs wins over
`training:`; the batch size is its `batch_size` or `batching.batch_size`
(default 20) of windows from the `training.batching` dataset, flattened
into (windows x observations x cameras) images. Loop, checkpoints, resume
and AutoencoderEvaluator as cli.common.run_training_loop. Runs on the card
by default; without one it raises unless `--device cpu`. Over several
processes (torchrun, as cli/train.py) the batch splits over a data axis of
every process, each taking its interleaved slice of the windows; the
encoder's and decoder's batch norms see the global batch.
"""

from __future__ import annotations

import argparse
import dataclasses


def main():
    parser = argparse.ArgumentParser(description="Phase-1 autoencoder training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch import config as config_lib
    from playableenvironments_tpu_torch.cli.common import (
        RunTimes, apply_debug_flags, autoencoder_training_config, build_dataset, load_yaml, output_dirs,
        rank_logger, resume_or_graft, run_training_loop,
    )
    from playableenvironments_tpu_torch.parallel import mesh as mesh_lib
    from playableenvironments_tpu_torch.train.trainer_autoencoder import AutoencoderTrainer
    from playableenvironments_tpu_torch.utils.device import resolve_device

    times = RunTimes()
    device = resolve_device(args.device)
    cfg = load_yaml(args.config)
    with mesh_lib.process_group(device), apply_debug_flags(cfg):
        results_dir, checkpoints_dir = output_dirs(cfg)
        # A data axis over every process (the JAX CLI's create_mesh()).
        mesh = mesh_lib.create_mesh(device=device)
        logger = rank_logger(mesh, results_dir, cfg.get("logging", {}).get("run_name", "ae"))
        scene = config_lib.scene_from_dict(cfg["model"], cfg.get("playable_model"))
        t = cfg.get("autoencoder_training") or cfg["training"]
        train_cfg = autoencoder_training_config(cfg)
        if args.max_steps:
            train_cfg = dataclasses.replace(train_cfg, max_steps=args.max_steps)
        trainer = AutoencoderTrainer(scene.autoencoder, train_cfg, device=device, seed=args.seed)
        dataset = build_dataset(cfg, "train")
        batch_size = int(t.get("batch_size") or t.get("batching", {}).get("batch_size", 20))
        if batch_size % mesh.data:
            raise ValueError(f"batch_size {batch_size} must divide over {mesh.data} devices")
        local_batch = batch_size // mesh.data

        def flat(batch):
            # (B, T, C, H, W, 3) -> (B * T * C, H, W, 3)
            obs = batch.observations
            return obs.reshape((-1,) + tuple(obs.shape[-3:]))

        def image_batches(epoch_seed, start):
            for batch in dataset.iterate_batches(local_batch, seed=epoch_seed, start=start,
                                                 process_index=mesh.data_index, process_count=mesh.data):
                yield flat(batch)

        resume_or_graft(trainer, checkpoints_dir, logger)
        mesh_lib.replicate(trainer.model, mesh)
        mesh_lib.compile_barrier(trainer.train_step)
        evaluate = None
        if int(t.get("eval_freq", 0)):
            from playableenvironments_tpu_torch.eval.autoencoder_evaluator import AutoencoderEvaluator

            try:
                val_dataset = build_dataset(cfg, "val")
            except FileNotFoundError:
                val_dataset = dataset
            evaluator = AutoencoderEvaluator(trainer, flat(next(val_dataset.iterate_batches(2, shuffle=False))))

            def evaluate(step):
                evaluator.evaluate(logger, step)

        run_training_loop(trainer, trainer.train_step, image_batches, (len(dataset) // mesh.data) // local_batch, t,
                          train_cfg.max_steps, checkpoints_dir, results_dir, logger, times, seed=args.seed,
                          device=device, evaluate=evaluate, mesh=mesh if mesh.size > 1 else None)
        times.write(results_dir, "train_autoencoder", mesh)
        logger.close()
    print(f"autoencoder training complete; checkpoints in {checkpoints_dir}")


if __name__ == "__main__":
    main()
