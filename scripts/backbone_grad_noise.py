#!/usr/bin/env python3
"""How far the fused backbone's backward kernel (B3) and its plain f32
version each are from the same bf16-operand products summed in f64, on one
CUDA card: the noise floor behind chip_smoke.py's B3 tolerances.

    python3 scripts/backbone_grad_noise.py

At the phase-2 launch shapes (18,432 and 147,456 points; tennis widths,
bf16; chip_smoke.py phase 5's inputs of the background and the first
player), prints for d_encoded and each weight and bias gradient the max and
mean error of the kernel and of the plain f32 version against
plain_backbone_bwd run in f64, relative to the tensor's largest magnitude.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("backbone_grad_noise: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import phase5_inputs
    from playableenvironments_tpu_torch.ops import fused_nerf

    for seed, points in ((2, 18432), (4, 147456)):
        cfg, packed, encoded, g_h, g_alpha = phase5_inputs(points, seed)
        with torch.no_grad():
            kernel, kernel_d = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
            plain, plain_d = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
            ref, ref_d = fused_nerf.plain_backbone_bwd(
                cfg, {k: v.double() for k, v in packed.items()}, encoded.double(), g_h.double(), g_alpha.double()
            )
        kernel["d_encoded"], plain["d_encoded"], ref["d_encoded"] = kernel_d, plain_d, ref_d
        worst = {"kernel": [0.0, 0.0], "plain f32": [0.0, 0.0]}
        for name in ref:
            scale = ref[name].abs().max().item()
            row = []
            for label, got in (("kernel", kernel[name]), ("plain f32", plain[name])):
                diff = (got.double() - ref[name]).abs()
                err, mean = diff.max().item() / scale, diff.mean().item() / scale
                row.append(f"{label} {err:.3e} (mean {mean:.3e})")
                if name != "d_encoded":
                    worst[label] = [max(worst[label][0], err), max(worst[label][1], mean)]
            print(f"{points} points {name}: " + ", ".join(row))
        print(f"{points} points, weights and biases, worst of each vs f64 sums: "
              + ", ".join(f"{k} {v[0]:.3e} (mean {v[1]:.3e})" for k, v in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
