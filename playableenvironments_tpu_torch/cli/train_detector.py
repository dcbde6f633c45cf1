"""Player-detector training entry point.

Port of playableenvironments_tpu/cli/train_detector.py:

    python -m playableenvironments_tpu_torch.cli.train_detector --config <yaml> [--max_steps N] \
        [--batch_size 8] [--seed 0] [--device cuda|cpu]

Trains train/trainer_detector.py's CenterNet detector on the boxes of
`<data_root>/train` (one observation a sample, resized to `data.target_size`
where the config has one), with the `detector_training` section's
`learning_rate` (1e-3), `weight_decay` (1e-4), `max_steps` (1000, or
`--max_steps`) and `base_features` (32). Each epoch shuffles with seed
`--seed` + the step it starts at. The running means of the losses go to the
logger every 50 steps; with `eval_freq`, every `eval_freq` steps the
detector is scored on `<data_root>/val` (the train split where there is
none), `eval_batches` (8) batches of MDR/ADD, logged as `val_*`. The
checkpoint `<checkpoints>/detector/checkpoint_<step>` plugs into
cli.evaluate_reconstructed_dataset's `--detector_checkpoint`; the seconds of
startup, steps, evaluation and the save go to
`<results>/timing_train_detector.json`. Runs on the card by default;
without one it raises unless `--device cpu`. `main()` returns the
checkpoint's path, each step's loss and the last validation.
"""

from __future__ import annotations

import argparse
import os


def main():
    parser = argparse.ArgumentParser(description="Player-detector training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.common import RunTimes, load_yaml, output_dirs, require_one_device
    from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
    from playableenvironments_tpu_torch.train import checkpointing
    from playableenvironments_tpu_torch.train.trainer_detector import (DetectorTrainer, DetectorTrainingConfig,
                                                                       dataset_detection_batches, evaluate_detection)
    from playableenvironments_tpu_torch.utils.device import resolve_device
    from playableenvironments_tpu_torch.utils.logger import Logger
    from playableenvironments_tpu_torch.utils.meters import AverageMeter

    times = RunTimes()
    device = resolve_device(args.device)
    cfg = load_yaml(args.config)
    require_one_device(cfg)
    results_dir, checkpoints_dir = output_dirs(cfg)
    checkpoints_dir = os.path.join(checkpoints_dir, "detector")
    os.makedirs(checkpoints_dir, exist_ok=True)
    logger = Logger(results_dir, "detector")

    d = cfg.get("detector_training", {})
    trainer_cfg = DetectorTrainingConfig(
        learning_rate=float(d.get("learning_rate", 1e-3)),
        weight_decay=float(d.get("weight_decay", 1e-4)),
        max_steps=int(args.max_steps or d.get("max_steps", 1000)),
        base_features=int(d.get("base_features", 32)),
    )
    trainer = DetectorTrainer(trainer_cfg, device=device, seed=args.seed)

    data_cfg = cfg["data"]
    target_size = tuple(data_cfg["target_size"]) if data_cfg.get("target_size") else None
    dataset = MulticameraVideoDataset(os.path.join(data_cfg["data_root"], "train"), observations_count=1,
                                      target_size=target_size)
    if len(dataset) < args.batch_size:
        raise ValueError(f"{len(dataset)} training samples make no batch of {args.batch_size}")
    # The validation split of the training-time detection quality; the
    # training split where there is none.
    eval_freq = int(d.get("eval_freq", 0))
    val_dataset = dataset
    val_dir = os.path.join(data_cfg["data_root"], "val")
    if eval_freq and os.path.isdir(val_dir):
        val_dataset = MulticameraVideoDataset(val_dir, observations_count=1, target_size=target_size)

    meter = AverageMeter()
    losses, validation = [], None
    step = 0
    times.startup_done()
    while step < trainer_cfg.max_steps:
        for images, boxes, validity in dataset_detection_batches(dataset, args.batch_size, seed=args.seed + step):
            with times.section("steps"):
                values = {k: float(v) for k, v in trainer.train_step(images, boxes, validity).items()}
            meter.add(values)
            losses.append(values["loss"])
            step += 1
            if step % 50 == 0:
                logger.log(meter.pop_all(), step)
            if eval_freq and step % eval_freq == 0:
                with times.section("evaluation"):
                    validation = evaluate_detection(
                        trainer, dataset_detection_batches(val_dataset, args.batch_size, shuffle=False),
                        max_batches=int(d.get("eval_batches", 8)))
                logger.log({f"val_{k}": v for k, v in validation.items()}, step)
            if step >= trainer_cfg.max_steps:
                break

    with times.section("saves"):
        path = checkpointing.save_checkpoint(checkpoints_dir, trainer, step)
    times.write(results_dir, "train_detector")
    logger.close()
    print(f"detector checkpoint written to {checkpoints_dir} (step {step})")
    return {"checkpoint": path, "losses": losses, "validation": validation}


if __name__ == "__main__":
    main()
