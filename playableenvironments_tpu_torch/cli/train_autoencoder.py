"""Phase-1 feature-renderer (VAE) training entry point.

Port of playableenvironments_tpu/cli/train_autoencoder.py:

    python -m playableenvironments_tpu_torch.cli.train_autoencoder --config <yaml> [--device cuda|cpu]

The `autoencoder_training:` block of the published configs wins over
`training:`; the batch size is its `batch_size` or `batching.batch_size`
(default 20) of windows from the `training.batching` dataset, flattened
into (windows x observations x cameras) images. Loop, checkpoints, resume
and AutoencoderEvaluator as cli.common.run_training_loop. Runs on the card
by default; without one it raises unless `--device cpu`.
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
        require_one_device, resume_or_graft, run_training_loop,
    )
    from playableenvironments_tpu_torch.train.trainer_autoencoder import AutoencoderTrainer
    from playableenvironments_tpu_torch.utils.device import resolve_device
    from playableenvironments_tpu_torch.utils.logger import Logger

    times = RunTimes()
    device = resolve_device(args.device)
    cfg = load_yaml(args.config)
    require_one_device(cfg)
    with apply_debug_flags(cfg):
        results_dir, checkpoints_dir = output_dirs(cfg)
        logger = Logger(results_dir, cfg.get("logging", {}).get("run_name", "ae"))
        scene = config_lib.scene_from_dict(cfg["model"], cfg.get("playable_model"))
        t = cfg.get("autoencoder_training") or cfg["training"]
        train_cfg = autoencoder_training_config(cfg)
        if args.max_steps:
            train_cfg = dataclasses.replace(train_cfg, max_steps=args.max_steps)
        trainer = AutoencoderTrainer(scene.autoencoder, train_cfg, device=device, seed=args.seed)
        dataset = build_dataset(cfg, "train")
        batch_size = int(t.get("batch_size") or t.get("batching", {}).get("batch_size", 20))

        def flat(batch):
            # (B, T, C, H, W, 3) -> (B * T * C, H, W, 3)
            obs = batch.observations
            return obs.reshape((-1,) + tuple(obs.shape[-3:]))

        def image_batches(epoch_seed, start):
            for batch in dataset.iterate_batches(batch_size, seed=epoch_seed, start=start):
                yield flat(batch)

        resume_or_graft(trainer, checkpoints_dir, logger)
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

        run_training_loop(trainer, trainer.train_step, image_batches, len(dataset) // batch_size, t,
                          train_cfg.max_steps, checkpoints_dir, results_dir, logger, times, seed=args.seed,
                          device=device, evaluate=evaluate)
        times.write(results_dir, "train_autoencoder")
        logger.close()
    print(f"autoencoder training complete; checkpoints in {checkpoints_dir}")


if __name__ == "__main__":
    main()
