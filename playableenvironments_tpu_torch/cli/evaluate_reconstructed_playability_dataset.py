"""Playability metrics: the paired quality metrics, the action-space
diagnostics with their plots, and FVD over camera 0's clips.

Port of playableenvironments_tpu/cli/evaluate_reconstructed_playability_dataset.py:

    python -m playableenvironments_tpu_torch.cli.evaluate_reconstructed_playability_dataset \
        --config <yaml> --generated <dir> [--output results.yaml] [--plots <dir>] [--device cuda|cpu]

eval.evaluators.ReconstructedPlayabilityDatasetEvaluator with the config's
`data.actions_count` (7 where it has none), FID on, and the plots always
written (`--plots`, default `<results>/plots`). The results go to
`--output` (default `<results>/reconstructed_playability_dataset_evaluation.yaml`),
the seconds split into decode, metrics and networks to
`<results>/timing_evaluate_reconstructed_playability_dataset.json`. Runs
on the card by default; without one it raises unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict


def main() -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--generated", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--plots", default=None, help="directory for movement density / mean-vector plots")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.evaluate_reconstructed_dataset import run_evaluation
    from playableenvironments_tpu_torch.eval.evaluators import ReconstructedPlayabilityDatasetEvaluator

    def evaluator(cfg, device, times, results_dir):
        return ReconstructedPlayabilityDatasetEvaluator(
            actions_count=int(cfg.get("data", {}).get("actions_count", 7)), compute_fid=True,
            plots_directory=args.plots or os.path.join(results_dir, "plots"), device=device, times=times)

    return run_evaluation(args, evaluator, "reconstructed_playability_dataset_evaluation.yaml",
                          "evaluate_reconstructed_playability_dataset")


if __name__ == "__main__":
    main()
