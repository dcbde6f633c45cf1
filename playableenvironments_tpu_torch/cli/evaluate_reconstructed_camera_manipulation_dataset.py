"""Paired metrics between the test split and a camera-manipulation mirror:
the plain reconstruction evaluator's metrics over the novel-view dataset of
generate_reconstructed_camera_manipulation_dataset.

Port of playableenvironments_tpu/cli/evaluate_reconstructed_camera_manipulation_dataset.py:

    python -m playableenvironments_tpu_torch.cli.evaluate_reconstructed_camera_manipulation_dataset \
        --config <yaml> --generated <dir> [--output results.yaml] [--window_size 16] [--no_fid] \
        [--device cuda|cpu]

The results go to `--output` (default
`<results>/reconstructed_camera_manipulation_dataset_evaluation.yaml`), the
seconds split into decode, metrics and networks to
`<results>/timing_evaluate_reconstructed_camera_manipulation_dataset.json`.
Runs on the card by default; without one it raises unless `--device cpu`.
"""

from __future__ import annotations

import argparse
from typing import Dict


def main() -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--generated", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--window_size", type=int, default=16)
    parser.add_argument("--no_fid", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.evaluate_reconstructed_dataset import run_evaluation
    from playableenvironments_tpu_torch.eval.evaluators import ReconstructedDatasetEvaluator

    return run_evaluation(
        args, lambda cfg, device, times, _: ReconstructedDatasetEvaluator(
            window_size=args.window_size, compute_fid=not args.no_fid, device=device, times=times),
        "reconstructed_camera_manipulation_dataset_evaluation.yaml",
        "evaluate_reconstructed_camera_manipulation_dataset")


if __name__ == "__main__":
    main()
