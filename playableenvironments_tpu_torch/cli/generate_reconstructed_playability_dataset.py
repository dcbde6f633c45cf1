"""Playability evaluation dataset: sequences re-enacted from one
ground-truth frame with the inferred actions (zero variation).

Port of playableenvironments_tpu/cli/generate_reconstructed_playability_dataset.py:

    python -m playableenvironments_tpu_torch.cli.generate_reconstructed_playability_dataset \
        --config <yaml> --environment_checkpoint <phase-2 checkpoint> \
        --playable_checkpoint <phase-3 checkpoint> [--output <dir>] [--observations_count 8] \
        [--seed 0] [--device cuda|cpu]

The phase-2 checkpoint is restored into the environment model
(restore_params), the phase-3 one with its centroids into a PlayableTrainer
(restore_checkpoint), as the play CLI does; `--seed` seeds the models
before the restores. The mirror (eval.creators.ReconstructedPlayabilityDatasetCreator,
inferred actions in its metadata.pkl) goes to `--output` (default
`<results>/reconstructed_playability_dataset`), the timing and launches to
`<results>/timing_generate_reconstructed_playability_dataset.json`. Runs
on the card by default; without one it raises unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os


def main() -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--environment_checkpoint", required=True)
    parser.add_argument("--playable_checkpoint", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--observations_count", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.common import RunTimes, load_yaml, output_dirs
    from playableenvironments_tpu_torch.cli.generate_reconstructed_dataset import build_renderer
    from playableenvironments_tpu_torch.eval.creators import ReconstructedPlayabilityDatasetCreator
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train import checkpointing
    from playableenvironments_tpu_torch.train.trainer_playable import PlayableTrainer, PlayableTrainingConfig
    from playableenvironments_tpu_torch.utils.device import resolve_device

    times = RunTimes()
    device = resolve_device(args.device)
    cfg = load_yaml(args.config)
    renderer, dataset, env_model = build_renderer(cfg, args.environment_checkpoint, device, seed=args.seed)
    playable = PlayableEnvironmentModel(
        env_model.scene, with_discriminators=checkpointing.has_discriminators(args.playable_checkpoint),
        device=device, seed=args.seed)
    trainer = PlayableTrainer(playable, PlayableTrainingConfig(), environment_model=env_model)
    checkpointing.restore_checkpoint(args.playable_checkpoint, trainer)
    results_dir, _ = output_dirs(cfg)
    output = args.output or os.path.join(results_dir, "reconstructed_playability_dataset")
    creator = ReconstructedPlayabilityDatasetCreator(renderer, playable.eval(),
                                                     trainer._per_object_centroids(trainer.centroids))
    times.startup_done()
    with times.section("steps"):
        creator.reconstruct_dataset(dataset, output, args.observations_count)
    times.write(results_dir, "generate_reconstructed_playability_dataset")
    print(f"playability dataset written to {output}")
    return output


if __name__ == "__main__":
    main()
