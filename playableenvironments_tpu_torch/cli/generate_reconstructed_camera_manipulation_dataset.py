"""Novel-view evaluation dataset: the frozen frame-0 scene along the
ground-truth camera trajectory.

Port of playableenvironments_tpu/cli/generate_reconstructed_camera_manipulation_dataset.py:

    python -m playableenvironments_tpu_torch.cli.generate_reconstructed_camera_manipulation_dataset \
        --config <yaml> --checkpoint <phase-2 checkpoint> [--output <dir>] [--observations_count 16] \
        [--device cuda|cpu]

Non-overlapping windows of `--observations_count` frames of the test split
(eval.creators.ReconstructedCameraManipulationDatasetCreator); the mirror
goes to `--output` (default `<results>/reconstructed_camera_manipulation_dataset`),
the timing and launches to
`<results>/timing_generate_reconstructed_camera_manipulation_dataset.json`.
Runs on the card by default; without one it raises unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os


def main() -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--observations_count", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.common import RunTimes, load_yaml, output_dirs
    from playableenvironments_tpu_torch.cli.generate_reconstructed_dataset import build_renderer
    from playableenvironments_tpu_torch.eval.creators import ReconstructedCameraManipulationDatasetCreator
    from playableenvironments_tpu_torch.utils.device import resolve_device

    times = RunTimes()
    cfg = load_yaml(args.config)
    renderer, dataset, _ = build_renderer(cfg, args.checkpoint, resolve_device(args.device))
    results_dir, _ = output_dirs(cfg)
    output = args.output or os.path.join(results_dir, "reconstructed_camera_manipulation_dataset")
    times.startup_done()
    with times.section("steps"):
        ReconstructedCameraManipulationDatasetCreator(renderer).reconstruct_dataset(
            dataset, output, args.observations_count)
    times.write(results_dir, "generate_reconstructed_camera_manipulation_dataset")
    print(f"camera-manipulation dataset written to {output}")
    return output


if __name__ == "__main__":
    main()
