#!/usr/bin/env python3
"""The published path's NeRF kernels timed on the card, to compare two
checkouts on one card: B1's tennis frame (one grouped launch of the four
objects, chip_smoke.py phase 2) and the decoder path's B2 launch of
1,310,720 points and B3 launch of 1,048,613 points (phase 13), each held
against its plain version as those phases hold it, timed by CUDA events
(the wrapper calls). Builds the checkout's kernels into its own _build/.

    python3 scripts/published_path_times.py [--repo DIR]

Run it for each checkout in one call to the card, in turns (parent,
change, change, parent). Prints one JSON line: the checkout, the card's
name and power limit, b1_frame_ms, b2_ms, b3_ms.
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"repo": repo, "card": card, "b1_frame_ms": group["ms"], "b2_ms": rows["fwd"]["ms"],
                      "b3_ms": rows["bwd"]["ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
