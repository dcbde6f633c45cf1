"""Phase-2 synthesis training entry point.

Port of playableenvironments_tpu/cli/train.py:

    python -m playableenvironments_tpu_torch.cli.train --config <yaml> [--device cuda|cpu]

Runs on the card by default; without one it raises unless `--device cpu`
asks for the CPU (the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import argparse


def main():
    parser = argparse.ArgumentParser(description="Phase-2 synthesis training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--max_steps", type=int, default=None, help="override training.max_steps (smoke runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.common import (
        RunTimes, apply_debug_flags, load_yaml, run_synthesis_training,
    )
    from playableenvironments_tpu_torch.utils.device import resolve_device

    times = RunTimes()
    device = resolve_device(args.device)
    cfg = load_yaml(args.config)
    with apply_debug_flags(cfg):
        checkpoints = run_synthesis_training(cfg, args.max_steps, args.seed, device, times)
    print(f"training complete; checkpoints in {checkpoints}")


if __name__ == "__main__":
    main()
