#!/usr/bin/env python3
"""Where the time of the eval-mode scene encoding of a dataset batch goes in
the PyTorch port, on one CUDA card.

    python3 scripts/profile_torch_encode.py [--batch 16] [--observations 9]

Writes chip_smoke.py phase 11's dataset (one training video, long enough
for `--batch` windows), takes one batch of `--batch` x `--observations`
frames at 288x512 and encodes it as `PlayableTrainer.encode_batch` does
(the phase-3 scene's EnvironmentModel, seeded weights, eval mode, no_grad).
It times, with the host clock around a synchronize, the batch's copy to the
card and the encoding apart (median of 10), then traces encodings with
torch.profiler and prints the device time by kernel name, the device-busy
share and the operation count. Writes the tables to
chiprun_out/profile_torch_encode.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--observations", type=int, default=9)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_encode: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from playableenvironments_tpu_torch.cli.common import build_dataset
    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel

    cs.DATA_SPLITS = {"train": (1, args.batch + args.observations - 1)}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tennis")
        cs.write_tennis_dataset(root)
        train = build_dataset(cs.tennis_config(repo=REPO, root=root, observations_count=args.observations,
                                               skip_frames=0), "train")
        batch = next(train.iterate_batches(args.batch, shuffle=False))
    model = EnvironmentModel(cs.phase3_scene(), cs.FOCAL_LENGTH_MULTIPLIER, device="cuda", seed=0).eval()

    def encode(on_card):
        with torch.no_grad():
            return model.compute_scene_encoding(*on_card.environment_model_args(), shuffle_style=False,
                                                train=False)[0]

    on_card = batch.to("cuda")
    for _ in range(3):
        encode(on_card)
    times = {"copy": [], "encode": []}
    for _ in range(10):
        torch.cuda.synchronize()
        start = time.perf_counter()
        on_card = batch.to("cuda")
        torch.cuda.synchronize()
        times["copy"].append((time.perf_counter() - start) * 1e3)
        start = time.perf_counter()
        encode(on_card)
        torch.cuda.synchronize()
        times["encode"].append((time.perf_counter() - start) * 1e3)
    medians = {k: statistics.median(v) for k, v in times.items()}

    from torch.profiler import ProfilerActivity, profile

    reps = 3
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            encode(on_card)
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - start) * 1e3 / reps
    rows = []
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0.0))
        if device_us > 0:
            rows.append({"name": event.key, "device_ms": device_us / 1e3 / reps, "count": event.count // reps})
    rows.sort(key=lambda r: -r["device_ms"])
    device_ms = sum(r["device_ms"] for r in rows)
    ops = sum(r["count"] for r in rows)
    frames = args.batch * args.observations
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip()
    print(f"eval encoding of {args.batch} x {args.observations} = {frames} frames at 288x512, 4 objects: "
          f"copy to the card {medians['copy']:.3f} ms ({batch.observations.numel() * 4 / 1e6:.1f} MB), encoding "
          f"{medians['encode']:.3f} ms (host clock, median of 10); traced {traced_ms:.3f} ms an encoding, "
          f"{device_ms:.3f} ms of device time ({100 * device_ms / traced_ms:.1f}% busy), {ops} device operations")
    for r in rows[:15]:
        print(f"  {r['device_ms']:8.3f} ms  x{r['count']:<5} {r['name'][:110]}")
    print(smi)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "profile_torch_encode.json"), "w") as f:
        json.dump({"card": smi, "frames": frames, "medians_ms": medians, "times_ms": times, "traced_ms": traced_ms,
                   "device_ms": device_ms, "device_ops": ops, "by_kernel": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
