#!/usr/bin/env python3
"""The published path's kernels timed on the card, to compare two checkouts
on one card: B1's tennis frame (one grouped launch of the four objects,
chip_smoke.py phase 2), the decoder path's B2 launch of 1,310,720 points
and B3 launch of 1,048,613 points (phase 13), and B4/B5 at the tennis
phase-3 shape (16 x 9, the dynamics 256 x 2; phase 8: B4 with and without
residuals, B5), each held against its plain version as those phases hold
it, timed by CUDA events (the wrapper calls; for B4/B5 also the launches
alone, from CUDA events in the launcher, which the host's time between
launches does not reach). Builds the checkout's kernels into its own
_build/.

    python3 scripts/published_path_times.py [--repo DIR]

Run it for each checkout in one call to the card, in turns (parent,
change, change, parent). Prints one JSON line: the checkout, the card's
name and power limit, b1_frame_ms, b2_ms, b3_ms, b4_res_ms, b4_ms, b5_ms and the
launches alone: b4_res_kernel_ms, b4_kernel_ms (the rollout kernel; the
image gathers apart, b4_res_image_ms, b4_image_ms), b5_recurrence_ms,
b5_wgrad_ms, b5_image_ms.
"""

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = parser.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from playableenvironments_tpu_torch.config import scene_from_yaml
    from playableenvironments_tpu_torch.ops import fused_nerf

    fused_nerf.build_kernels()
    scene = scene_from_yaml(os.path.join(repo, "configs", "tennis.yaml"))
    _, group = chip_smoke.phase2_adain_kernels(scene, {})
    rows = chip_smoke.phase13_backbone_kernels(1_310_720)
    _, rollout = chip_smoke.phase8_rollout_kernels()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"repo": repo, "card": card, "b1_frame_ms": group["ms"], "b2_ms": rows["fwd"]["ms"],
                      "b3_ms": rows["bwd"]["ms"], "b4_res_ms": rollout["fwd_res_ms"], "b4_ms": rollout["fwd_ms"],
                      "b5_ms": rollout["bwd_ms"], "b4_res_kernel_ms": rollout["fwd_res_kernel_ms"],
                      "b4_kernel_ms": rollout["fwd_kernel_ms"], "b4_res_image_ms": rollout["fwd_res_image_ms"],
                      "b4_image_ms": rollout["fwd_image_ms"], "b5_recurrence_ms": rollout["bwd_recurrence_ms"],
                      "b5_wgrad_ms": rollout["bwd_wgrad_ms"], "b5_image_ms": rollout["bwd_image_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
