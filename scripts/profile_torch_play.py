#!/usr/bin/env python3
"""Where the time of one play-loop step goes in the PyTorch port, on one
CUDA card.

    python3 scripts/profile_torch_play.py [--steps 6] [--config tennis|minecraft]

Builds the chip_smoke.py session of the config (configs/tennis.yaml or
configs/minecraft.yaml, seeded weights, 512x288, strides 4 and 8, the
phase-4 or phase-12 frame-0 state), warms up, then:
- times the parts of a step with the host clock around a synchronize: the
  dynamics step, render_rays_fast (and within it the skybox MLP, where the
  scene has one), and the decode (the remainder of render_frame_fast);
- traces whole steps with torch.profiler and prints the device time by
  kernel name, the device-busy share of the step and the launch count.
Writes the tables to chiprun_out/profile_torch_play.json
(profile_torch_play_minecraft.json for Minecraft).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--config", choices=("tennis", "minecraft"), default="tennis")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_play: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from chip_smoke import IMAGE_SIZE, STRIDES
    from playableenvironments_tpu_torch.cli.play import InteractiveSession
    from playableenvironments_tpu_torch.config import scene_from_yaml
    from playableenvironments_tpu_torch.models.nerf import SkyboxNerfMLP
    from playableenvironments_tpu_torch.render import fast
    from playableenvironments_tpu_torch.render.interactive import action_inputs, interactive_step

    minecraft = args.config == "minecraft"
    ACTIONS = chip_smoke.MINECRAFT_ACTIONS if minecraft else chip_smoke.ACTIONS
    scene = scene_from_yaml(os.path.join(REPO, "configs", f"{args.config}.yaml"))
    session = InteractiveSession.from_scene(
        scene, image_size=IMAGE_SIZE, patch_strides=STRIDES, device="cuda", seed=0,
        focal_length_multiplier=chip_smoke.MINECRAFT_MULTIPLIER if minecraft else chip_smoke.FOCAL_LENGTH_MULTIPLIER,
    )
    session.start((chip_smoke.minecraft_encoding if minecraft else chip_smoke.tennis_encoding)(torch, "cuda"))
    for i in range(3):
        session.step(list(ACTIONS[i]))

    # Parts of a step, host clock around a synchronize.
    real_render_rays = fast.render_rays_fast
    real_skybox = SkyboxNerfMLP.forward
    parts = {"dynamics": [], "render_rays_fast": [], "decode_and_rest": [], "step": []}
    if minecraft:
        parts["skybox_mlp"] = []

    def timed_skybox(*a, **k):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real_skybox(*a, **k)
        torch.cuda.synchronize()
        parts["skybox_mlp"].append((time.perf_counter() - start) * 1e3)
        return out

    def timed_render_rays(*a, **k):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real_render_rays(*a, **k)
        torch.cuda.synchronize()
        parts["render_rays_fast"].append((time.perf_counter() - start) * 1e3)
        return out

    fast.render_rays_fast = timed_render_rays
    if minecraft:
        SkyboxNerfMLP.forward = timed_skybox
    try:
        for i in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_hots, variations = action_inputs(session.playable_model, list(ACTIONS[i % len(ACTIONS)]), "cuda")
            session.encoding, session.carries = interactive_step(
                session.playable_model, session.encoding, session.initial_style, session.carries,
                one_hots, variations,
            )
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            session.render(session.encoding)[0, 0, 0].cpu().numpy()
            t2 = time.perf_counter()
            parts["dynamics"].append((t1 - t0) * 1e3)
            parts["step"].append((t2 - t0) * 1e3)
            parts["decode_and_rest"].append((t2 - t1) * 1e3 - parts["render_rays_fast"][-1])
    finally:
        fast.render_rays_fast = real_render_rays
        SkyboxNerfMLP.forward = real_skybox
    medians = {k: statistics.median(v) for k, v in parts.items()}
    print("step parts, median ms (host clock, synchronized):",
          ", ".join(f"{k} {v:.3f}" for k, v in medians.items()))

    # Trace whole steps.
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(args.steps):
            session.step(list(ACTIONS[i % len(ACTIONS)]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / args.steps
    rows = []
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = evt.self_cuda_time_total
        # aten:: rows are host operators carrying their kernels' device time;
        # count the device events (kernels, copies) themselves.
        if device_us > 0 and not evt.key.startswith("aten::"):
            rows.append({"name": evt.key, "device_ms_per_step": device_us / 1e3 / args.steps,
                         "calls_per_step": evt.count / args.steps})
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    device_ms = sum(r["device_ms_per_step"] for r in rows)
    launches = sum(r["calls_per_step"] for r in rows)
    print(f"traced: wall {wall_ms:.3f} ms/step, device busy {device_ms:.3f} ms/step "
          f"({100 * device_ms / wall_ms:.1f}%), {launches:.0f} device ops/step (profiler on)")
    for r in rows[:25]:
        print(f"  {r['device_ms_per_step']:9.4f} ms {r['calls_per_step']:7.1f}x  {r['name'][:110]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = "profile_torch_play_minecraft.json" if minecraft else "profile_torch_play.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump({"parts_ms": parts, "medians_ms": medians, "traced_wall_ms": wall_ms,
                   "device_ms": device_ms, "device_ops": launches, "kernels": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
