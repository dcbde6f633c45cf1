"""Standalone FVD between the test split and a reconstructed dataset (the
reference's own entry point, kept for CLI parity).

Port of playableenvironments_tpu/cli/evaluate_fvd_reconstructed_dataset.py:

    python -m playableenvironments_tpu_torch.cli.evaluate_fvd_reconstructed_dataset --config <yaml> \
        --generated <dir> [--output results.yaml] [--clip_length 16] [--device cuda|cpu]

The results go to `--output` (default
`<results>/reconstructed_dataset_fvd_evaluation.yaml`), the seconds split
into decode, metrics and networks to
`<results>/timing_evaluate_fvd_reconstructed_dataset.json`. Runs on the
card by default; without one it raises unless `--device cpu`.
"""

from __future__ import annotations

import argparse
from typing import Dict


def main() -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--generated", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--clip_length", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.evaluate_reconstructed_dataset import run_evaluation
    from playableenvironments_tpu_torch.eval.evaluators import ReconstructedDatasetFVDEvaluator

    return run_evaluation(
        args, lambda cfg, device, times, _: ReconstructedDatasetFVDEvaluator(
            clip_length=args.clip_length, device=device, times=times),
        "reconstructed_dataset_fvd_evaluation.yaml", "evaluate_fvd_reconstructed_dataset")


if __name__ == "__main__":
    main()
