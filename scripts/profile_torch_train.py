#!/usr/bin/env python3
"""Where the time of one phase-2 train step goes in the PyTorch port, on one
CUDA card.

    python3 scripts/profile_torch_train.py [--steps 4]

Builds chip_smoke.py's phase-2 main path (bench.py's step: the tennis
model at full width with the bf16 fused backbone, bs 8 x 4 observations x
144 weighted rays at 288x512, Adam; seeded random weights), warms up two
steps, then:
- times the parts of a step with the host clock around a synchronize: the
  forward with the losses, the backward, the optimizer update;
- traces whole steps with torch.profiler and prints the device time by
  kernel name and by kind (the B2/B3 kernels, GEMMs, convolutions and
  batch norm, the rest), the device-busy share of the step and the number
  of device operations.
Writes the tables to chiprun_out/profile_torch_train.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kind_of(name: str) -> str:
    """A coarse class of a device kernel, from its name."""
    lowered = name.lower()
    if "backbone_" in lowered:
        return "fused backbone (B2/B3)"
    if "fused_adain_nerf" in lowered:
        return "B1"
    if "conv" in lowered or "cudnn" in lowered or "implicit" in lowered or "wgrad" in lowered or "dgrad" in lowered:
        return "convolution (cuDNN)"
    if "batch_norm" in lowered or "bn_" in lowered:
        return "batch norm"
    if "gemm" in lowered or "sm90_xmma" in lowered or "cutlass" in lowered or "ampere" in lowered or "matmul" in lowered:
        return "GEMM (cuBLAS)"
    if "memcpy" in lowered or "memset" in lowered:
        return "copies and fills"
    if "reduce" in lowered:
        return "reductions"
    if "elementwise" in lowered or "vectorized" in lowered:
        return "elementwise"
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=4)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from chip_smoke import phase2_batch, phase2_scene
    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
    from playableenvironments_tpu_torch.train.trainer_synthesis import (
        LossWeights, SynthesisTrainer, SynthesisTrainingConfig,
    )
    from playableenvironments_tpu_torch.utils.random import RngStreams

    model = EnvironmentModel(phase2_scene(), device="cuda", seed=0)
    trainer = SynthesisTrainer(model, SynthesisTrainingConfig(
        samples_per_image=144,
        loss_weights=LossWeights(reconstruction=1.0, opacity=0.01, attention=0.01, bounding_box=0.1),
    ))
    batch = phase2_batch(torch, 8, 4, 288, 512, "cuda")
    rng = RngStreams(0, "cuda")
    for _ in range(2):
        trainer.train_step(batch, rng)

    parts = {"forward_and_losses": [], "backward": [], "optimizer": [], "step": []}
    for _ in range(args.steps):
        model.train()
        trainer.optimizer.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = trainer.compute_losses(batch, rng, trainer.step)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, ms in (("forward_and_losses", t1 - t0), ("backward", t2 - t1), ("optimizer", t3 - t2),
                         ("step", t3 - t0)):
            parts[name].append(ms * 1e3)
    medians = {k: statistics.median(v) for k, v in parts.items()}
    print("step parts, median ms (host clock, synchronized):",
          ", ".join(f"{k} {v:.3f}" for k, v in medians.items()))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(batch, rng)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / args.steps
    from torch.autograd import DeviceType

    events = prof.key_averages()
    # Host rows (aten:: operators, autograd Functions) and annotations that
    # also show on the device (Optimizer.step) carry their kernels' device
    # time; count the device events (kernels, copies) themselves.
    host_names = {evt.key for evt in events if evt.device_type == DeviceType.CPU}
    rows = []
    for evt in events:
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = evt.self_cuda_time_total
        if device_us > 0 and evt.device_type == DeviceType.CUDA and evt.key not in host_names:
            rows.append({"name": evt.key, "kind": kind_of(evt.key),
                         "device_ms_per_step": device_us / 1e3 / args.steps,
                         "calls_per_step": evt.count / args.steps})
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    device_ms = sum(r["device_ms_per_step"] for r in rows)
    launches = sum(r["calls_per_step"] for r in rows)
    kinds = {}
    for r in rows:
        kinds[r["kind"]] = kinds.get(r["kind"], 0.0) + r["device_ms_per_step"]
    print(f"traced: wall {wall_ms:.3f} ms/step, device busy {device_ms:.3f} ms/step "
          f"({100 * device_ms / wall_ms:.1f}%), {launches:.0f} device ops/step (profiler on)")
    print("device ms/step by kind: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(kinds.items(), key=lambda x: -x[1])))
    for r in rows[:30]:
        print(f"  {r['device_ms_per_step']:9.4f} ms {r['calls_per_step']:7.1f}x  {r['name'][:110]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "profile_torch_train.json"), "w") as f:
        json.dump({"parts_ms": parts, "medians_ms": medians, "traced_wall_ms": wall_ms,
                   "device_ms": device_ms, "device_ops": launches, "device_ms_by_kind": kinds,
                   "kernels": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
