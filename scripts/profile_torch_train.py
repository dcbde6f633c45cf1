#!/usr/bin/env python3
"""Where the time of one train step goes in the PyTorch port, on one CUDA
card: the phase-1 VAE step, the phase-2 synthesis step (direct rays, the
published decoder path, or that path with every option) or the phase-3
action-module G+D step.

    python3 scripts/profile_torch_train.py [--phase 1|2|3] [--decoder [--config tennis|minecraft]
        [--consistency]] [--options] [--steps 4] [--repo DIR]

Builds chip_smoke.py's main path of that phase, seeded random weights:
phase 1, bench.py's step (chip_smoke.py 13e: the v8 autoencoder in bf16,
bs 20 of 288x512, perceptual 0.1 and KL 5e-6, Adam); phase 2, bench.py's
step (the tennis model at full width with the bf16 fused backbone, bs 8 x
4 observations x 144 weighted rays at 288x512, Adam), or with `--decoder`
the config's published decoder path at chip_smoke.py's per-card batch
(13b / 13c: one strided patch an image decoded by the VAE, the
autoencoder's frozen rate group; with `--consistency`, 15a's step: the
pose, keypoint and keypoint-opacity passes on chip_smoke.py's made-up
flow and keypoints), or with `--options` chip_smoke.py 14c's
step (tennis.yaml's decoder path at bs 1 x 4 with use_fine, separate fine
fields, the fused backbone at the YAML's f32, divergence, camera offsets
and remat; chip_smoke.py::options_config); phase 3, bench.py's fused G+D step (bs
16 x 9 observations, 2 players, dynamics 2 x 256, action network 3 x 128,
GAN and ACMV). Warms up two steps, then:
- times the parts of a step with the host clock around a synchronize:
  phases 1 and 2, the forward with the losses, the backward, the optimizer
  update; phase 3, the generator's forward with the losses, its backward,
  its Adam update, and the whole discriminator pass;
- traces whole steps with torch.profiler and prints the device time by
  kernel name and by kind (the B2/B3 or B4/B5 kernels, B2-f32 and B3-f32
  apart, GEMMs, convolutions and batch norm, the rest), each kind's share
  of the device time, the device-busy share of the step and the number of
  device operations.
`--repo DIR` profiles the checkout at DIR (its package and chip_smoke.py)
instead of this one, so that two commits can be read in one call.
Writes the tables to chiprun_out/profile_torch_train[_phase1|_phase3|
_decoder_<config>[_consistency]|_options][_<DIR name>].json.
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
    if "backbone_f32_fwd" in lowered:
        return "B2-f32"
    if "backbone_f32_pack" in lowered:
        return "B2-f32 weight images"
    if "backbone_f32_" in lowered:
        return "B3-f32"
    if "backbone_" in lowered:
        return "fused backbone (B2/B3)"
    if "adain_nerf" in lowered:
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
    return (lambda: trainer.train_step(batch, rng)), split_step(trainer, model,
                                                                lambda: trainer.compute_losses(batch, rng, trainer.step))


def decoder_step(config, consistency=False):
    """(one train step, one step timed in parts) of chip_smoke.py's
    decoder-path main path of `config` (13b / 13c), with `consistency`
    15a's passes on."""
    import torch

    from chip_smoke import DECODER_BATCH, DECODER_IMAGE, DECODER_OBSERVATIONS, decoder_batch, published_phase2_config
    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cfg = published_phase2_config(REPO, config)
    model = build_environment_model(cfg, device="cuda", seed=0)
    train_cfg = synthesis_training_config(cfg)
    batch = decoder_batch(torch, config, DECODER_BATCH[config], DECODER_OBSERVATIONS[config], *DECODER_IMAGE, "cuda")
    if consistency:
        from chip_smoke import consistency_batch, with_consistency

        batch, train_cfg = consistency_batch(batch, model), with_consistency(train_cfg)
    trainer = SynthesisTrainer(model, train_cfg)
    rng = RngStreams(0, "cuda")
    return (lambda: trainer.train_step(batch, rng)), split_step(trainer, trainer.model,
                                                                lambda: trainer.compute_losses(batch, rng, trainer.step))


def options_step():
    """(one train step, one step timed in parts) of chip_smoke.py's 14c:
    tennis.yaml's phase 2 at full width with every option on."""
    import torch

    from chip_smoke import DECODER_IMAGE, PHASE14_BATCH, PHASE14_OBSERVATIONS, options_batch, options_config
    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cfg = options_config(REPO, tiny=False)
    model = build_environment_model(cfg, device="cuda", seed=0)
    trainer = SynthesisTrainer(model, synthesis_training_config(cfg))
    batch = options_batch(torch, PHASE14_BATCH, PHASE14_OBSERVATIONS, *DECODER_IMAGE, "cuda")
    rng = RngStreams(0, "cuda")
    return (lambda: trainer.train_step(batch, rng)), split_step(trainer, trainer.model,
                                                                lambda: trainer.compute_losses(batch, rng, trainer.step))


def phase1_step():
    """(one train step, one step timed in parts) of chip_smoke.py's phase-1
    main path (13e)."""
    import numpy as np
    import torch

    from chip_smoke import DECODER_IMAGE, PHASE1_BATCH, phase1_trainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    trainer = phase1_trainer("v8", "bfloat16", "cuda")
    images = torch.from_numpy(np.random.default_rng(0).random((PHASE1_BATCH,) + DECODER_IMAGE + (3,),
                                                               np.float32)).cuda()
    rng = RngStreams(0, "cuda")
    return (lambda: trainer.train_step(images, rng)), split_step(trainer, trainer.model,
                                                                 lambda: trainer.compute_losses(images, rng))


def split_step(trainer, model, forward):
    """One optimizer step timed in parts: `forward()` (the loss first),
    the backward, the update."""

    def parts(torch):
        model.train()
        trainer.optimizer.zero_grad()
        times = []
        _clock(torch, times)
        loss = forward()[0]
        _clock(torch, times)
        loss.backward()
        _clock(torch, times)
        trainer.optimizer.step()
        _clock(torch, times)
        return ("forward_and_losses", "backward", "optimizer"), times

    return parts


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
    parser.add_argument("--phase", type=int, choices=(1, 2, 3), default=2)
    parser.add_argument("--decoder", action="store_true", help="phase 2 on the published decoder path")
    parser.add_argument("--config", choices=("tennis", "minecraft"), default="tennis")
    parser.add_argument("--consistency", action="store_true",
                        help="the decoder path with the consistency passes (chip_smoke.py 15a)")
    parser.add_argument("--options", action="store_true", help="phase 2 with every option (chip_smoke.py 14c)")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--repo", default=None, help="profile the checkout at this directory")
    args = parser.parse_args()
    if (args.decoder or args.options) and args.phase != 2:
        parser.error("--decoder and --options are phase-2 paths")
    if args.decoder and args.options:
        parser.error("--options is the decoder path with every option; give one of the two")
    if args.consistency and not args.decoder:
        parser.error("--consistency is an option of --decoder")
    global REPO
    if args.repo:
        REPO = os.path.abspath(args.repo)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if args.phase == 1:
        step_fn, parts_fn = phase1_step()
    elif args.decoder:
        step_fn, parts_fn = decoder_step(args.config, args.consistency)
    elif args.options:
        step_fn, parts_fn = options_step()
    else:
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
    label = f"phase-{args.phase}" + (f" {args.config} decoder-path" if args.decoder else "") + (
        " with the consistency passes" if args.consistency else "") + (
        " tennis with every option" if args.options else "") + (f" ({REPO})" if args.repo else "")
    print(f"{label} step parts, median ms (host clock, synchronized):",
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
    print("device ms/step by kind (share of device time): " + ", ".join(
        f"{k} {v:.3f} ({100 * v / device_ms:.1f}%)" for k, v in sorted(kinds.items(), key=lambda x: -x[1])))
    for r in rows[:30]:
        print(f"  {r['device_ms_per_step']:9.4f} ms {r['calls_per_step']:7.1f}x  {r['name'][:110]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    suffix = f"_decoder_{args.config}" if args.decoder else ("" if args.phase == 2 else f"_phase{args.phase}")
    suffix += "_consistency" if args.consistency else ""
    suffix += "_options" if args.options else ""
    suffix += f"_{os.path.basename(REPO)}" if args.repo else ""
    name = f"profile_torch_train{suffix}.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump({"parts_ms": parts, "medians_ms": medians, "traced_wall_ms": wall_ms,
                   "device_ms": device_ms, "device_ops": launches, "device_ms_by_kind": kinds,
                   "kernels": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
