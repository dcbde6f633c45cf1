#!/usr/bin/env python3
"""The published path's kernels timed on the card, to compare two checkouts
on one card: B1's tennis frame (one grouped launch of the four objects,
chip_smoke.py phase 2), the decoder path's B2 launch of 1,310,720 points
and B3 launch of 1,048,613 points (phase 13), and B4/B5 at the tennis
phase-3 shape (16 x 9, the dynamics 256 x 2; phase 8: B4 with and without
residuals, B5), each held against its plain version as those phases hold
it, and B2-f32/B3-f32 at 147,456 points (phase 14a's player shape), timed
by CUDA events (the wrapper calls; for B4/B5 also the launches
alone, from CUDA events in the launcher, which the host's time between
launches does not reach). Builds the checkout's kernels into its own
_build/.

    python3 scripts/published_path_times.py [--repo DIR]

Run it for each checkout in one call to the card, in turns (parent,
change, change, parent). Prints one JSON line: the checkout, the card's
name and power limit, b1_frame_ms, b2_ms, b3_ms, b4_res_ms, b4_ms, b5_ms and the
launches alone: b4_res_kernel_ms, b4_kernel_ms (the rollout kernel; the
image gathers apart, b4_res_image_ms, b4_image_ms), b5_recurrence_ms,
b5_wgrad_ms, b5_image_ms; and the launches alone of B1-B3 and of the f32
kernels: b1_back_to_back_ms (the grouped frame launch enqueued back to
back), b2_kernel_ms and b2_f32_kernel_ms (B2 and B2-f32 on prebuilt
weight buffers, back to back), b2_f32_image_ms (the f32 pack kernel: a launch is shorter than
the host's time to enqueue it, so `queued_ms` holds the stream with a spin
kernel while the host enqueues 200 launches, the median of 9 such runs;
b2_f32_image_ms_runs lists them), b3_kernels_ms and b3_f32_kernels_ms (the sum of the backward's
kernels by CUDA events in its launcher, the median of three backwards).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys


def queued_ms(torch, fn, reps=200, runs=9, spin_cycles=200_000_000):
    """Device milliseconds per call of `fn` where a call is shorter than
    the host's time to enqueue it: a spin kernel (~0.1 s) holds the stream
    while the host enqueues `reps` calls between two events, which then run
    back to back. :return: (median, the `runs` readings)."""
    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end) / reps)
    return statistics.median(readings), readings


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
    with torch.no_grad():
        cfg, packed, encoded, g_h, g_alpha = chip_smoke.phase5_inputs(147_456, seed=33, compute_dtype="float32")
        f32 = fused_nerf.backbone_f32_buffers(cfg, packed)
        b2_f32_kernel_ms = chip_smoke.cuda_ms_back_to_back(
            lambda: fused_nerf.fused_backbone_fwd(cfg, packed, encoded, f32), reps=10)
        b2_f32_image_ms, b2_f32_image_runs = queued_ms(torch, lambda: fused_nerf.backbone_f32_buffers(cfg, packed))
        b3_f32_kernels_ms = sorted(sum(fused_nerf.backbone_f32_bwd_breakdown(cfg, packed, encoded, g_h, g_alpha,
                                                                              f32).values()) for _ in range(3))[1]
        del encoded, g_h, g_alpha, f32
        cfg, packed, encoded, _, _ = chip_smoke.phase5_inputs(1_310_720, seed=31)
        buffers = fused_nerf.backbone_buffers(cfg, packed)
        b2_kernel_ms = chip_smoke.cuda_ms_back_to_back(lambda: fused_nerf.fused_backbone_fwd(cfg, packed, encoded,
                                                                                            buffers), reps=10)
        del encoded, buffers
        cfg, packed, encoded, g_h, g_alpha = chip_smoke.phase5_inputs(chip_smoke.B3_LARGE_POINTS, seed=32)
        saved = encoded.to(torch.bfloat16)
        b3_kernels_ms = sorted(sum(fused_nerf.backbone_bwd_breakdown(cfg, packed, saved, g_h, g_alpha).values())
                               for _ in range(3))[1]
        del encoded, saved, g_h, g_alpha
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"repo": repo, "card": card, "b1_frame_ms": group["ms"], "b2_ms": rows["fwd"]["ms"],
                      "b3_ms": rows["bwd"]["ms"], "b4_res_ms": rollout["fwd_res_ms"], "b4_ms": rollout["fwd_ms"],
                      "b5_ms": rollout["bwd_ms"], "b4_res_kernel_ms": rollout["fwd_res_kernel_ms"],
                      "b4_kernel_ms": rollout["fwd_kernel_ms"], "b4_res_image_ms": rollout["fwd_res_image_ms"],
                      "b4_image_ms": rollout["fwd_image_ms"], "b5_recurrence_ms": rollout["bwd_recurrence_ms"],
                      "b5_wgrad_ms": rollout["bwd_wgrad_ms"], "b5_image_ms": rollout["bwd_image_ms"],
                      "b2_f32_kernel_ms": b2_f32_kernel_ms, "b2_f32_image_ms": b2_f32_image_ms,
                      "b2_f32_image_ms_runs": b2_f32_image_runs,
                      "b3_f32_kernels_ms": b3_f32_kernels_ms, "b1_back_to_back_ms": group["back_to_back_ms"],
                      "b2_kernel_ms": b2_kernel_ms, "b3_kernels_ms": b3_kernels_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
