"""Paired metrics between the test split and a reconstructed dataset.

Port of playableenvironments_tpu/cli/evaluate_reconstructed_dataset.py:

    python -m playableenvironments_tpu_torch.cli.evaluate_reconstructed_dataset --config <yaml> \
        --generated <dir> [--output results.yaml] [--window_size 16] [--no_fid] [--device cuda|cpu]

eval.evaluators.ReconstructedDatasetEvaluator over `<data_root>/test` and
`--generated`; the results go to `--output` (default
`<results>/reconstructed_dataset_evaluation.yaml`), the seconds split into
decode, metrics and networks to `<results>/timing_evaluate_reconstructed_dataset.json`.
`--detector_checkpoint` raises NotImplementedError: the detector is not
ported yet (ROADMAP queue A, Evaluation: the detector). The metric
networks run on the card by default; without one it raises unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict


def run_evaluation(args, evaluator_factory, default_name: str, timing_name: str) -> Dict[str, float]:
    """Shared body of the evaluate_* CLIs: the config's test split against
    `args.generated`, the results written as YAML and printed.
    :param evaluator_factory: (device, RunTimes) -> an evaluator."""
    from playableenvironments_tpu_torch.cli.common import RunTimes, load_yaml, output_dirs, require_one_device
    from playableenvironments_tpu_torch.eval.evaluators import save_results_yaml
    from playableenvironments_tpu_torch.utils.device import resolve_device

    times = RunTimes()
    cfg = load_yaml(args.config)
    require_one_device(cfg)
    reference_root = os.path.join(cfg["data"]["data_root"], "test")
    results_dir, _ = output_dirs(cfg)
    evaluator = evaluator_factory(cfg, resolve_device(args.device), times, results_dir)
    times.startup_done()
    results = evaluator.compute_metrics(reference_root, args.generated)
    output = args.output or os.path.join(results_dir, default_name)
    save_results_yaml(results, output)
    times.write(results_dir, timing_name)
    for key, value in sorted(results.items()):
        print(f"{key}: {value}")
    print(f"results written to {output}")
    return results


def main() -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--generated", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--window_size", type=int, default=16)
    parser.add_argument("--no_fid", action="store_true")
    parser.add_argument("--detector_checkpoint", default=None,
                        help="trained detector checkpoint; enables the MDR/ADD detection metrics (not ported)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.detector_checkpoint:
        raise NotImplementedError(
            "--detector_checkpoint: the detector (models/detector.py, train/trainer_detector.py) is not ported "
            "(ROADMAP queue A, Evaluation: the detector)")

    from playableenvironments_tpu_torch.eval.evaluators import ReconstructedDatasetEvaluator

    return run_evaluation(
        args, lambda cfg, device, times, _: ReconstructedDatasetEvaluator(
            window_size=args.window_size, compute_fid=not args.no_fid, device=device, times=times),
        "reconstructed_dataset_evaluation.yaml", "evaluate_reconstructed_dataset")


if __name__ == "__main__":
    main()
