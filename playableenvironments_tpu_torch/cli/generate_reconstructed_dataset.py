"""Render the test split into a mirrored dataset.

Port of playableenvironments_tpu/cli/generate_reconstructed_dataset.py:

    python -m playableenvironments_tpu_torch.cli.generate_reconstructed_dataset --config <yaml> \
        --checkpoint <phase-2 checkpoint> [--output <dir>] [--batch_size 4] [--device cuda|cpu]

`build_renderer` (shared with the camera-manipulation and playability
CLIs) restores a port phase-2 checkpoint into the config's environment
model (train/checkpointing.py::restore_params) and wraps it in the
creators' FrameRenderer at the test split's frame size, with the
autoencoder's patch strides where the model decodes. The mirror goes to
`--output` (default `<results>/reconstructed_dataset`), the run's timing
and B1-B5 launches to `<results>/timing_generate_reconstructed_dataset.json`.
Runs on the card by default; without one it raises unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os


def build_renderer(cfg, checkpoint: str, device="cuda", seed: int = 0):
    """(FrameRenderer of the restored environment model, the test split in
    windows of one observation, the environment model), on `device`."""
    from playableenvironments_tpu_torch.cli.common import (
        build_dataset, build_environment_model, require_one_device, with_batching_overrides,
    )
    from playableenvironments_tpu_torch.eval.creators import FrameRenderer
    from playableenvironments_tpu_torch.train import checkpointing

    require_one_device(cfg)
    env_model = build_environment_model(cfg, device=device, seed=seed)
    checkpointing.restore_params(checkpoint, env_model)
    dataset = build_dataset(with_batching_overrides(cfg, observations_count=1), "test")
    strides = None
    if env_model.scene.autoencoder is not None:
        from playableenvironments_tpu_torch.models.autoencoder import autoencoder_strides

        strides = autoencoder_strides(env_model.scene.autoencoder)
    renderer = FrameRenderer(env_model, getattr(env_model, "autoencoder", None), dataset.videos[0].image_size(),
                             strides)
    return renderer, dataset, env_model


def main() -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.common import RunTimes, load_yaml, output_dirs
    from playableenvironments_tpu_torch.eval.creators import ReconstructedDatasetCreator
    from playableenvironments_tpu_torch.utils.device import resolve_device

    times = RunTimes()
    cfg = load_yaml(args.config)
    renderer, dataset, _ = build_renderer(cfg, args.checkpoint, resolve_device(args.device))
    results_dir, _ = output_dirs(cfg)
    output = args.output or os.path.join(results_dir, "reconstructed_dataset")
    times.startup_done()
    with times.section("steps"):
        ReconstructedDatasetCreator(renderer, args.batch_size).reconstruct_dataset(dataset, output)
    times.write(results_dir, "generate_reconstructed_dataset")
    print(f"reconstructed dataset written to {output}")
    return output


if __name__ == "__main__":
    main()
