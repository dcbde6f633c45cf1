#!/usr/bin/env python3
"""B1 on the eval ray split's slices, on trained weights.

    python3 scripts/check_b1_split.py [trainings]

Runs chip_smoke.py phase 16's CLIs (dataset and checkpoints) `trainings`
times (default 2; phase 2's default algorithms are not deterministic, so
each training gives other weights), then renders the test split's first
frame through FrameRenderer split over rays 2 on [cuda:0, cuda:0] and
unsplit, capturing each grouped B1 launch. For each launch and object it
prints, in chip_smoke.py's unit (the output's mean magnitude where it
exceeds 1): the kernel's largest and mean error against plain_adain_nerf,
both versions' largest and mean distance from the same function with every
sum in float64 (check_b1_batch.py's reference), the rows whose error
exceeds 1e-3 and 1e-2, and whether the grouped launch equals the object
launched alone and launched again bit for bit. Writes the rows to
chiprun_out/check_b1_split.json. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_b1_split: needs a CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from check_b1_batch import f64_reference
    from playableenvironments_tpu_torch.cli.common import load_yaml
    from playableenvironments_tpu_torch.cli.generate_reconstructed_dataset import build_renderer
    from playableenvironments_tpu_torch.eval.creators import FrameRenderer
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.parallel.mesh import create_device_mesh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fused_nerf.build_kernels()
    grouped = fused_nerf.fused_adain_nerf_group
    rows = []
    for training in range(int(sys.argv[1]) if len(sys.argv) > 1 else 2):
        with cs.cli_directory() as directory:
            paths = cs.phase16_cli(repo, directory)["paths"]
            cfg = load_yaml(cs.phase16_config(repo, directory, "split", paths["data_root"]))
            renderer, dataset, env_model = build_renderer(cfg, paths["environment"], "cuda")
            encoding = renderer.encode(next(dataset.iterate_batches(1, shuffle=False)))
            split = FrameRenderer(env_model, renderer.autoencoder, renderer.image_size, renderer.patch_strides,
                                  mesh=create_device_mesh(["cuda:0", "cuda:0"], data=1))
            for path, frame_renderer in (("split", split), ("whole", renderer)):
                captured = []

                def capture(cfg_nerf, items):
                    outs = grouped(cfg_nerf, items)
                    captured.append((cfg_nerf, items, outs))
                    return outs

                fused_nerf.fused_adain_nerf_group = capture
                try:
                    with torch.no_grad():
                        frame_renderer.render(encoding)
                finally:
                    fused_nerf.fused_adain_nerf_group = grouped
                for launch, (cfg_nerf, items, outs) in enumerate(captured):
                    with torch.no_grad():
                        again = grouped(cfg_nerf, items)
                    for index, (item, (feats, alpha)) in enumerate(zip(items, outs)):
                        args = (item.encoded, item.scale0, item.bias0, item.scale1, item.bias1)
                        with torch.no_grad():
                            plain = fused_nerf.plain_adain_nerf(cfg_nerf, item.weights.packed, *args,
                                                                item.samples_per_ray)
                            exact = f64_reference(cfg_nerf, item.weights.packed, *args, item.samples_per_ray)
                            alone = fused_nerf.fused_adain_nerf(cfg_nerf, item.weights, *args,
                                                                samples_per_ray=item.samples_per_ray)
                        row = {"training": training, "path": path, "launch": launch, "object": index,
                               "points": item.encoded.shape[0],
                               "alone_equal": all(torch.equal(a, b) for a, b in zip(alone, (feats, alpha))),
                               "again_equal": all(torch.equal(a, b) for a, b in zip(again[index], (feats, alpha)))}
                        for name, got, ref, ex in (("features", feats, plain[0], exact[0]),
                                                   ("alpha", alpha, plain[1], exact[1])):
                            unit = max(1.0, ref.abs().mean().item())
                            err = (got - ref).abs() / unit
                            kernel, plain_f64 = (got.double() - ex).abs() / unit, (ref.double() - ex).abs() / unit
                            per_row = err if err.dim() == 1 else err.amax(dim=-1)
                            row[name] = {"unit": unit, "max": err.max().item(), "mean": err.mean().item(),
                                         "kernel_f64_max": kernel.max().item(), "kernel_f64_mean": kernel.mean().item(),
                                         "plain_f64_max": plain_f64.max().item(),
                                         "plain_f64_mean": plain_f64.mean().item(),
                                         "rows_over_1e-3": int((per_row > 1e-3).sum()),
                                         "rows_over_1e-2": int((per_row > 1e-2).sum())}
                        rows.append(row)
                        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "check_b1_split.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
