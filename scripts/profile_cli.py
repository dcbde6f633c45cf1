#!/usr/bin/env python3
"""Where one of the port's CLIs spends its wall time, by Python function.

    python3 scripts/profile_cli.py [--top 25] [--phase 1|2]

Writes phase 11's dataset (chip_smoke.write_tennis_dataset) into a
temporary directory and runs, in this process under cProfile, chip_smoke.py
16a's train_autoencoder (--phase 1) or 16a then 16b's train (--phase 2) on
configs/tennis.yaml at full width with phase 16's changes; prints the
CLI's timing file (startup, steps, saves, evaluation), the functions with
the most cumulative time, and the card's name and power limit. cProfile
adds cost to every Python call, so read its shares, not its seconds.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--phase", type=int, choices=(1, 2), default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_cli: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    os.environ["WANDB_MODE"] = "disabled"
    directory = tempfile.mkdtemp(prefix="profile_cli_")
    try:
        data = os.path.join(directory, "data")
        chip_smoke.write_tennis_dataset(data)
        ae_config = chip_smoke.phase16_config(REPO, directory, "phase1", data,
                                              autoencoder_training=chip_smoke.PHASE16_AE,
                                              **{"training.batching": {"observations_count": 1}})
        runs = [("train_autoencoder", ["--config", ae_config], "phase1")]
        if args.phase == 2:
            ae_path = os.path.join(directory, "checkpoints", "phase1", "checkpoint_3")
            config = chip_smoke.phase16_config(
                REPO, directory, "phase2", data, training=chip_smoke.PHASE16_PHASE2,
                **{"training.batching": {"batch_size": chip_smoke.PHASE16_PHASE2_BATCH},
                   "model.autoencoder": {"weights_filename": ae_path}})
            runs.append(("train", ["--config", config], "phase2"))
        for index, (cli, cli_args, run) in enumerate(runs):
            profiler = cProfile.Profile() if index == len(runs) - 1 else None
            if profiler:
                profiler.enable()
            chip_smoke.run_cli(f"playableenvironments_tpu_torch.cli.{cli}", *cli_args, "--device", "cuda")
            if profiler:
                profiler.disable()
        with open(os.path.join(directory, "results", run, f"timing_{cli}.json")) as f:
            print(f"{cli}: {json.load(f)}")
        pstats.Stats(profiler).sort_stats("cumulative").print_stats(args.top)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
