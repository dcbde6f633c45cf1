#!/usr/bin/env python3
"""Where the time of one train step goes in the PyTorch port, on one CUDA
card: the phase-2 synthesis step or the phase-3 action-module G+D step.

    python3 scripts/profile_torch_train.py [--phase 2|3] [--steps 4]

Builds chip_smoke.py's main path of that phase, seeded random weights:
phase 2, bench.py's step (the tennis model at full width with the bf16
fused backbone, bs 8 x 4 observations x 144 weighted rays at 288x512,
Adam); phase 3, bench.py's fused G+D step (bs 16 x 9 observations, 2
players, dynamics 2 x 256, action network 3 x 128, GAN and ACMV). Warms up
two steps, then:
- times the parts of a step with the host clock around a synchronize:
  phase 2, the forward with the losses, the backward, the optimizer
  update; phase 3, the generator's forward with the losses, its backward,
  its Adam update, and the whole discriminator pass;
- traces whole steps with torch.profiler and prints the device time by
  kernel name and by kind (the B2/B3 or B4/B5 kernels, GEMMs,
  convolutions and batch norm, the rest), the device-busy share of the
  step and the number of device operations.
Writes the tables to chiprun_out/profile_torch_train.json (phase 2) or
chiprun_out/profile_torch_train_phase3.json.
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
    if "rollout_" in lowered:
        return "fused rollout (B4/B5)"
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


def _clock(torch, times):
    torch.cuda.synchronize()
    times.append(time.perf_counter())


def phase2_step():
    """(one train step, one step timed in parts) of chip_smoke.py's phase-2
    main path."""
    import torch

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

    def parts(torch):
        model.train()
        trainer.optimizer.zero_grad()
        times = []
        _clock(torch, times)
        loss, _, _ = trainer.compute_losses(batch, rng, trainer.step)
        _clock(torch, times)
        loss.backward()
        _clock(torch, times)
        trainer.optimizer.step()
        _clock(torch, times)
        return ("forward_and_losses", "backward", "optimizer"), times

    return (lambda: trainer.train_step(batch, rng)), parts


def phase3_step():
    """(one fused G+D step, one step timed in parts) of chip_smoke.py's
    phase-3 main path; the parts are PlayableTrainer.fused_step's own
    calls, in its order."""
    from chip_smoke import phase3_trainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    trainer, encoding = phase3_trainer("cuda", seed=0)
    rng = RngStreams(0, "cuda")

    def parts(torch):
        trainer.playable_model.train()
        trainer.optimizer.zero_grad()
        step = trainer.step
        times = []
        _clock(torch, times)
        loss, _, extra, _ = trainer.compute_losses(encoding, rng, step)
        _clock(torch, times)
        loss.backward()
        _clock(torch, times)
        trainer.optimizer.step()
        trainer.centroids, trainer.mi_matrices = extra["centroids"], extra["mi_matrices"]
        _clock(torch, times)
        trainer.discriminator_step(encoding, rng, step)
        _clock(torch, times)
        return ("generator_forward_and_losses", "generator_backward", "generator_adam", "discriminator_pass"), times

    return (lambda: trainer.fused_step(encoding, rng)), parts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", type=int, choices=(2, 3), default=2)
    parser.add_argument("--steps", type=int, default=4)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    step_fn, parts_fn = phase2_step() if args.phase == 2 else phase3_step()
    for _ in range(2):
        step_fn()

    parts = {}
    for _ in range(args.steps):
        times = parts_fn(torch)
        for name, ms in list(zip(times[0], [b - a for a, b in zip(times[1], times[1][1:])])) + [
                ("step", times[1][-1] - times[1][0])]:
            parts.setdefault(name, []).append(ms * 1e3)
    medians = {k: statistics.median(v) for k, v in parts.items()}
    print(f"phase-{args.phase} step parts, median ms (host clock, synchronized):",
          ", ".join(f"{k} {v:.3f}" for k, v in medians.items()))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(args.steps):
            step_fn()
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
    name = "profile_torch_train.json" if args.phase == 2 else "profile_torch_train_phase3.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump({"parts_ms": parts, "medians_ms": medians, "traced_wall_ms": wall_ms,
                   "device_ms": device_ms, "device_ops": launches, "device_ms_by_kind": kinds,
                   "kernels": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
