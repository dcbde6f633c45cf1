#!/usr/bin/env python3
"""How far B1 and honest f32 versions of its function sit from the f64 sums.

    python3 scripts/check_b1_f64_spread.py [seeds] [orders] [trainings]

For each of `seeds` seeded tennis models (default 24) it renders the
reconstruction creator's batch-4 launch (check_b1_batch.py's inputs), and
for each of `trainings` (default 0) runs chip_smoke.py phase 16's CLIs
(phase 2's default algorithms are not deterministic, so each training
gives other weights) and records the camera-manipulation creator's first
launch as phase 17 does. Over each launch's objects and outputs it takes
the largest distance from
the same function summed in float64 (check_b1_batch.py's reference) of:
the kernel; plain_adain_nerf and the same function with its hidden units
in `orders` (default 7) other orders (chip_smoke.py's honest_adain: the
same bf16 roundings, other summation orders); and the same with the
products on the tensor cores (cuBLAS's bf16 GEMM with f32 sums, as the
kernel's), in the plain order and the `orders` others. It prints a row for
each launch and, for chip_smoke.py's PHASE17_B1_F64_RATIO, how many
launches fail a hold of the kernel against the plain version alone and
against the farthest of the honest versions (f32, tensor cores, both),
and the largest ratio between two honest versions of one launch; and, for
each object's features and alpha, the mean distance from the f64 sums of
the kernel over the plain version's and over the tensor-core version's
(in the plain order). Writes
the rows to chiprun_out/check_b1_f64_spread.json. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_b1_f64_spread: needs a CUDA card", file=sys.stderr)
        return 1
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    orders = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    trainings = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from check_b1_batch import creator_batch, f64_reference, first_b1_launch
    from playableenvironments_tpu_torch.ops import fused_nerf

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fused_nerf.build_kernels()
    batch, scene = creator_batch(repo)

    def launches():
        for seed in range(seeds):
            yield f"seed {seed}", first_b1_launch(scene, batch, seed)
        for training in range(trainings):
            with cs.cli_directory() as directory:
                paths = cs.phase16_cli(repo, directory)["paths"]
                config = cs.phase16_config(repo, directory, "spread", paths["data_root"],
                                           **{"training.batching": {"skip_frames": cs.PHASE17_SKIP}})
                with cs.Phase17Recorder() as recorder:
                    cs.run_cli("playableenvironments_tpu_torch.cli.generate_reconstructed_camera_manipulation_dataset",
                               "--config", config, "--checkpoint", paths["environment"], "--observations_count",
                               cs.PHASE17_OBSERVATIONS, "--output", os.path.join(directory, "tree"), "--device",
                               "cuda")
                yield f"training {training}", recorder.b1

    rows = []
    for index, (label, (cfg, items, outs)) in enumerate(launches()):
        generator = torch.Generator().manual_seed(1000 + index)
        row = {"launch": label, "points": sum(item.encoded.shape[0] for item in items), "kernel": 0.0, "plain": 0.0,
               "reordered": [0.0] * orders, "tensor_cores": [0.0] * (orders + 1), "mean_over_plain": [],
               "mean_over_tensor_cores": []}
        with torch.no_grad():
            for item, got in zip(items, outs):
                args = (item.encoded, item.scale0, item.bias0, item.scale1, item.bias1, item.samples_per_ray)
                exact = f64_reference(cfg, item.weights.packed, *args)

                def distance(version):
                    return max((v.double() - r).abs().max().item() for v, r in zip(version, exact))

                plain = fused_nerf.plain_adain_nerf(cfg, item.weights.packed, *args)
                row["kernel"] = max(row["kernel"], distance(got))
                row["plain"] = max(row["plain"], distance(plain))
                tensor_cores = cs.honest_adain(cfg, item.weights.packed, *args, tensor_cores=True)
                for k, p, t, r in zip(got, plain, tensor_cores, exact):
                    mean = (k.double() - r).abs().mean().item()
                    row["mean_over_plain"].append(mean / (p.double() - r).abs().mean().item())
                    row["mean_over_tensor_cores"].append(mean / (t.double() - r).abs().mean().item())
                for k in range(orders):
                    row["reordered"][k] = max(row["reordered"][k], distance(cs.honest_adain(
                        cfg, item.weights.packed, *args, generator)))
                for k in range(orders + 1):
                    row["tensor_cores"][k] = max(row["tensor_cores"][k], distance(cs.honest_adain(
                        cfg, item.weights.packed, *args, generator if k else None, tensor_cores=True)))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del items, outs
        torch.cuda.empty_cache()
    ratio = cs.PHASE17_B1_F64_RATIO

    def over(reference):
        return sum(r["kernel"] > ratio * reference(r) for r in rows)

    def honest(r):
        return [r["plain"]] + r["reordered"] + r["tensor_cores"]

    summary = {"seeds": seeds, "trainings": trainings, "ratio": ratio,
               "kernel_over_plain": over(lambda r: r["plain"]),
               "kernel_over_farthest_f32": over(lambda r: max([r["plain"]] + r["reordered"])),
               "kernel_over_farthest_tensor_cores": over(lambda r: max(r["tensor_cores"])),
               "kernel_over_farthest_honest": over(lambda r: max(honest(r))),
               "kernel_over_plain_ratio_max": max(r["kernel"] / r["plain"] for r in rows),
               "kernel_over_farthest_honest_ratio_range": [min(r["kernel"] / max(honest(r)) for r in rows),
                                                           max(r["kernel"] / max(honest(r)) for r in rows)],
               "honest_pair_ratio_max": max(max(honest(r)) / min(honest(r)) for r in rows),
               "mean_over_plain_range": [min(min(r["mean_over_plain"]) for r in rows),
                                         max(max(r["mean_over_plain"]) for r in rows)],
               "mean_over_tensor_cores_range": [min(min(r["mean_over_tensor_cores"]) for r in rows),
                                                max(max(r["mean_over_tensor_cores"]) for r in rows)],
               "tensor_cores_over_plain_ratio_range": [min(q / r["plain"] for r in rows for q in r["tensor_cores"]),
                                                       max(q / r["plain"] for r in rows for q in r["tensor_cores"])]}
    print(json.dumps(summary))
    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "check_b1_f64_spread.json"), "w") as f:
        json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
