#!/usr/bin/env python3
"""B1 through its registered operator against the same launch called
directly, in one process on one CUDA card.

    python3 scripts/b1_dispatch.py [--rounds 5] [--steps 12]

`ops/fused_nerf.py::fused_adain_nerf_group` calls B1 as the operator
`playableenvironments_torch::fused_adain_nerf_group`; "direct" swaps in the
operator's own CUDA function (the same ctypes launch, no dispatcher).
Alternating the two paths `--rounds` times each, on chip_smoke.py's tennis
session at 512x288 (seeded weights, the phase-4 state):
- the frame's grouped call at its recorded inputs: CUDA events around one
  call (as called, the host's dispatch included) and around 20 calls back
  to back, medians;
- the play loop: the median of `--steps` steps (host clock around a step
  that ends in the frame's copy to the host).
Prints the card's name and power limit; writes chiprun_out/b1_dispatch.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--steps", type=int, default=12)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("b1_dispatch: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from playableenvironments_tpu_torch.cli.play import InteractiveSession
    from playableenvironments_tpu_torch.config import scene_from_yaml
    from playableenvironments_tpu_torch.ops import fused_nerf

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    scene = scene_from_yaml(os.path.join(REPO, "configs", "tennis.yaml"))
    session = InteractiveSession.from_scene(
        scene, image_size=chip_smoke.IMAGE_SIZE, patch_strides=chip_smoke.STRIDES, device="cuda", seed=0,
        focal_length_multiplier=chip_smoke.FOCAL_LENGTH_MULTIPLIER)
    session.start(chip_smoke.tennis_encoding(torch, "cuda"))

    grouped, recorded = fused_nerf.fused_adain_nerf_group, []

    def record(cfg, items):
        recorded.append((cfg, items))
        return grouped(cfg, items)

    fused_nerf.fused_adain_nerf_group = record
    session.step(list(chip_smoke.ACTIONS[0]))
    fused_nerf.fused_adain_nerf_group = grouped
    cfg, items = recorded[0]
    operator = fused_nerf._adain_group_op
    paths = {"operator": operator, "direct": operator._init_fn}

    def steps_ms():
        times = []
        for i in range(args.steps):
            start = time.perf_counter()
            session.step(list(chip_smoke.ACTIONS[i % len(chip_smoke.ACTIONS)]))
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times)

    results = {name: {"call_ms": [], "back_to_back_ms": [], "step_ms": []} for name in paths}
    try:
        for _ in range(args.rounds):
            for name, fn in paths.items():
                fused_nerf._adain_group_op = fn
                results[name]["call_ms"].append(chip_smoke.cuda_ms(lambda: grouped(cfg, items)))
                results[name]["back_to_back_ms"].append(chip_smoke.cuda_ms_back_to_back(lambda: grouped(cfg, items)))
                results[name]["step_ms"].append(steps_ms())
    finally:
        fused_nerf._adain_group_op = operator
    summary = {name: {k: statistics.median(v) for k, v in r.items()} for name, r in results.items()}
    print(card)
    for name, r in summary.items():
        print(f"{name}: the grouped call {r['call_ms']:.4f} ms as called, {r['back_to_back_ms']:.4f} ms back to "
              f"back; the play step {r['step_ms']:.3f} ms (medians of {args.rounds} rounds; each round "
              f"{[round(x, 3) for x in results[name]['step_ms']]} ms)")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "b1_dispatch.json"), "w") as f:
        json.dump({"card": card, "rounds": results, "medians": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
