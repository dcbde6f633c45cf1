#!/usr/bin/env python3
"""What sets chip_smoke.py phase 6's gradient bound: the phase-2 direct-ray
step card vs CPU, three ways, on one CUDA card.

    python3 scripts/phase6_bound.py

chip_smoke.phase6_readings's step (the phase-2 scene at full width, 1 x 2
observations of 288x512, randomness off, seeded weights) on the card and on
the CPU: (1) as PyTorch's defaults leave it (cuDNN convolutions in TF32) with
B2/B3 on the card; (2) both steps inside chip_smoke.ieee_convolutions (TF32
off) with B2/B3; (3) inside ieee_convolutions with the plain backbone on both
devices (no B2/B3). Prints, for each, the largest gradient error against its
model's largest gradient and the tensor that has it, the largest mean error
against a tensor's own largest, the running statistics' and the loss's
errors, and the card's name and power limit; writes chiprun_out/
phase6_bound.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("phase6_bound: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    scene = chip_smoke.phase2_scene()
    plain = dataclasses.replace(scene, object_models=tuple(
        dataclasses.replace(om, nerf=dataclasses.replace(om.nerf, use_fused_backbone=False))
        for om in scene.object_models))
    readings = {}
    for label, variant, convolutions in (
            ("tf32, B2/B3", scene, lambda device: contextlib.nullcontext()),
            ("ieee, B2/B3", scene, chip_smoke.ieee_convolutions),
            ("ieee, plain backbone", plain, chip_smoke.ieee_convolutions)):
        worst = chip_smoke.phase6_readings(variant, convolutions)
        worst.pop("worst_gradients")
        readings[label] = worst
        print(f"{label}: gradient max err {worst['grad_rel_err']:.3e} of its model's largest "
              f"({worst['worst_gradient']}), mean err up to {worst['grad_mean_rel_err']:.3e} of a tensor's own; "
              f"running statistics {worst['stats_err']:.3e}; metrics {worst['metric_rel_err']:.3e} relative")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "phase6_bound.json"), "w") as f:
        json.dump({"card": smi, "readings": readings}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
