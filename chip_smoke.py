#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: the tennis play loop.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. build the port's CUDA kernel (csrc/fused_nerf.cu) with nvcc;
2. hold the kernel against its plain PyTorch version at the four per-frame
   launch shapes of the tennis scene, and time kernel, plain version, a
   library yardstick (the same MLP as a chain of bf16 torch.matmul, never
   called by the port) and the bound;
3. check a small frame, its composited NeRF features and the dynamics state
   against the same seeded modules on the CPU;
4. drive the main path: configs/tennis.yaml at full width with seeded random
   weights, an InteractiveSession at 512x288 (strides 4 and 8), scripted
   steps for both players; every frame (288, 512, 3), finite, in [0, 1], and
   4 kernel launches per frame.
Prints one JSON line of kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# The card's dense bf16 tensor-core peak and memory rate (H100 SXM data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Kernel vs plain version: the same bf16 operand rounding, but f32 sums in
# another order, which flips an occasional bf16 rounding of an activation
# (one bf16 step is 0.4% of it) and carries the flip to the outputs. At the
# background shape the plain version alone moves by up to 1.2e-2 when its
# sums are taken in f64 instead of f32, for 1e-5 of its outputs. So each
# element is held to 3e-2 + 1e-2 |ref|, and the mean error, which such rare
# flips leave near 1e-6, to 1e-4.
KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL = 3e-2, 1e-2, 1e-4
# The card's frame vs the CPU's (same weights): the kernel vs the plain MLP
# as above, plus TF32 convolutions in the decoder.
FRAME_ATOL = 1e-2
# Per-frame launches of the tennis scene: (object, rays, samples).
TENNIS_LAUNCHES = (("background", 4320, 4), ("backplate", 11520, 4),
                   ("player_1", 1440, 32), ("player_2", 1440, 32))
IMAGE_SIZE = (288, 512)
STRIDES = (4, 8)
FOCAL_LENGTH_MULTIPLIER = 0.51417  # configs/tennis.yaml data.focal_length_multiplier
STEPS = 12
ACTIONS = [(1, 2), (3, 4), (0, 6), (5, 1), (2, 2), (6, 0)]


def fail(message: str) -> int:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr)
    return 1


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median over `reps` of CUDA-event times of one call of `fn`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tennis_encoding(torch, device):
    """The interactive benchmark's frame-0 state (bench.py's
    _interactive_setup): camera behind the court, players at y=-5 and -10."""
    from playableenvironments_tpu_torch.scene.encoding import SceneEncoding

    n = 4
    translations = torch.zeros(1, 1, n, 3)
    translations[:, :, 2, 1] = -5.0
    translations[:, :, 3, 1] = -10.0
    return SceneEncoding(
        camera_rotations=torch.tensor([[[[-0.15, 0.0, 0.0]]]]),
        camera_translations=torch.tensor([[[[0.0, -30.0, 10.0]]]]),
        focals=torch.full((1, 1, 1), 600.0),
        object_rotations=torch.zeros(1, 1, n, 3),
        object_translations=translations,
        object_style=torch.ones(1, 1, n, 64) * 0.1,
        object_deformation=torch.ones(1, 1, n, 32) * 0.1,
        object_in_scene=torch.ones(1, 1, n, dtype=torch.bool),
    ).map(lambda x: x.to(device))


def library_mlp(cfg, bf, encoded, s0, b0, s1, b1, samples):
    """The same MLP as a chain of bf16 torch.matmul calls (cuBLAS) over the
    bf16 weights `bf`: the yardstick `library_ms`. Timed only; the port
    never calls it."""
    import torch

    enc = encoded.to(torch.bfloat16)
    h = enc
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx:
            h = torch.cat([h, enc], dim=-1)
        h = torch.relu(h @ bf[f"w{i}"] + bf[f"b{i}"])
    alpha = h @ bf["w_alpha"] + bf["b_alpha"]
    mods = [m.to(torch.bfloat16).repeat_interleave(samples, dim=0) for m in (s0, b0, s1, b1)]
    f = torch.relu((h @ bf["w_f0"]) * mods[0] + mods[1])
    f = torch.relu((f @ bf["w_f1"]) * mods[2] + mods[3])
    return f @ bf["w_out"] + bf["b_out"], alpha


def mlp_work(cfg, packed, points: int, rays: int):
    """(flops, bytes) the MLP must do and move for `points` points: each
    input read once (encodings, per-ray modulation, weights), each output
    written once."""
    width = cfg.layers_width
    pe = packed["w0"].shape[0]
    out = packed["w_out"].shape[1]
    macs = sum(w.numel() for k, w in packed.items() if k.startswith("w"))
    flops = 2.0 * macs * points
    weight_bytes = 2 * macs + 4 * sum(b.numel() for k, b in packed.items() if k.startswith("b"))
    bytes_ = points * pe * 2 + rays * 3 * width * 4 + weight_bytes + points * (out + 1) * 4
    return flops, bytes_


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "playableenvironments_tpu_torch")):
        return fail(f"the port's package is not beside {__file__}")
    sys.path.insert(0, repo)

    from playableenvironments_tpu_torch.cli.play import InteractiveSession
    from playableenvironments_tpu_torch.config import scene_from_yaml
    from playableenvironments_tpu_torch.models.encoding import positional_encoding
    from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
    from playableenvironments_tpu_torch.models.layers import initialize_
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.render.fast import frame_rays, render_rays_fast

    device = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ---------------------------------------------------------
    start = time.perf_counter()
    report = fused_nerf.build_kernel()
    print(f"build: csrc/fused_nerf.cu in {time.perf_counter() - start:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 2. kernel vs plain version at the tennis launch shapes -------------
    scene = scene_from_yaml(os.path.join(repo, "configs", "tennis.yaml"))
    cfg = scene.object_models[0].nerf
    generator = torch.Generator().manual_seed(0)
    nerf = AdaInNerfMLP(cfg, scene.object_models[0].style_features, device=device)
    initialize_(nerf, generator)
    weights = nerf.kernel_weights()
    bf16_weights = {k: v.to(torch.bfloat16) for k, v in weights.packed.items()}
    shapes = []
    for name, rays, samples in TENNIS_LAUNCHES:
        points = rays * samples
        positions = torch.rand(points, 3, generator=generator) * 2.0 - 1.0
        encoded = positional_encoding(positions, cfg.position_encoder.octaves, True)
        encoded = encoded.to(device=device, dtype=torch.bfloat16)
        style = torch.randn(rays, 64, generator=generator).to(device)
        with torch.no_grad():
            s0, b0 = fused_nerf.fold_adain_stats(nerf.adain_0, style)
            s1, b1 = fused_nerf.fold_adain_stats(nerf.adain_1, style)
            args = (encoded, s0, b0, s1, b1)
            feats, alpha = fused_nerf.fused_adain_nerf(cfg, weights, *args, samples_per_ray=samples)
            torch.cuda.synchronize()
            ref_feats, ref_alpha = fused_nerf.plain_adain_nerf(cfg, weights.packed, *args, samples)
            errs, mean_errs = [], []
            for got, ref in ((feats, ref_feats), (alpha, ref_alpha)):
                if got.shape != ref.shape or not torch.isfinite(got).all():
                    return fail(f"{name}: kernel output has shape {tuple(got.shape)} or non-finite values")
                diff = (got - ref).abs()
                within = bool((diff <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all())
                if not within or not diff.mean().item() <= KERNEL_MEAN_ATOL:
                    return fail(
                        f"{name}: kernel differs from its plain version by up to "
                        f"{diff.max().item():.3e}, {diff.mean().item():.3e} on average"
                    )
                mean_errs.append(diff.mean().item())
                errs.append(diff.max().item())
                errs.append((diff / ref.abs().clamp(min=1e-3)).max().item())
            ms = cuda_ms(lambda: fused_nerf.fused_adain_nerf(cfg, weights, *args, samples_per_ray=samples))
            plain_ms = cuda_ms(lambda: fused_nerf.plain_adain_nerf(cfg, weights.packed, *args, samples))
            library_ms = cuda_ms(lambda: library_mlp(cfg, bf16_weights, *args, samples))
        flops, bytes_ = mlp_work(cfg, weights.packed, points, rays)
        bound_ms = max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES_PER_S) * 1e3
        shapes.append({
            "object": name, "rays": rays, "samples": samples, "points": points,
            "max_abs_err": max(errs[0], errs[2]), "max_rel_err": max(errs[1], errs[3]),
            "mean_abs_err": max(mean_errs),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS > bytes_ / PEAK_BYTES_PER_S else "bytes",
            "gflop": flops / 1e9, "mbytes": bytes_ / 1e6,
        })
        print(
            f"kernel {name} ({rays} rays x {samples} = {points} points): "
            f"max abs err {shapes[-1]['max_abs_err']:.3e}, max rel err {shapes[-1]['max_rel_err']:.3e}, "
            f"mean abs err {shapes[-1]['mean_abs_err']:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({shapes[-1]['bound_by']}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s"
        )

    # ---- 3. the card against the CPU on a small frame ----------------------
    small = dict(image_size=(48, 64), patch_strides=STRIDES,
                 focal_length_multiplier=FOCAL_LENGTH_MULTIPLIER * 64 / 512)
    card = InteractiveSession.from_scene(scene, device="cuda", seed=0, **small)
    host = InteractiveSession.from_scene(scene, device="cpu", seed=0, **small)
    encoding = tennis_encoding(torch, "cpu")
    frame_err = 0.0
    for i in range(3):
        if i == 0:
            got, ref = card.start(encoding), host.start(encoding)
        else:
            got, ref = card.step(list(ACTIONS[i])), host.step(list(ACTIONS[i]))
        frame_err = max(frame_err, float(abs(got - ref).max()))
        state_err = (card.encoding.object_translations.cpu() - host.encoding.object_translations).abs().max().item()
        if not frame_err <= FRAME_ATOL or not state_err <= 1e-4:
            return fail(f"small frame {i}: card vs CPU frame err {frame_err:.3e}, translation err {state_err:.3e}")
    print(f"small frame 48x64: card vs CPU max abs err {frame_err:.3e} (tolerance {FRAME_ATOL})")
    # The decoder's random weights squash frames toward 0.5, so compare the
    # composited NeRF integrals of the last state too. Their scale is set by
    # the random weights, so the bounds are relative to it: the kernel's
    # rare bf16 flips (see KERNEL_ATOL) move an integral by well under 1% of
    # the largest one, and its mean error far less.
    integrals = [
        render_rays_fast(scene, s.composer, *frame_rays(s.encoding, **small))["coarse"]["global"]
        for s in (card, host)
    ]
    for field in ("integrated_features", "opacity", "depth"):
        got, ref = integrals[0][field].cpu(), integrals[1][field]
        diff = (got - ref).abs()
        scale = ref.abs().max().item()
        if not (scale > 0 and diff.max().item() <= 2e-2 * scale and diff.mean().item() <= 1e-3 * scale):
            return fail(f"{field}: card vs CPU err up to {diff.max().item():.3e}, "
                        f"mean {diff.mean().item():.3e}, scale {scale:.3e}")
        print(f"small frame {field}: card vs CPU max abs err {diff.max().item():.3e}, "
              f"mean {diff.mean().item():.3e} (values in [{ref.min().item():.3f}, {ref.max().item():.3f}])")

    # ---- 4. the main path: the tennis play loop at 512x288 ----------------
    session = InteractiveSession.from_scene(
        scene, image_size=IMAGE_SIZE, patch_strides=STRIDES,
        focal_length_multiplier=FOCAL_LENGTH_MULTIPLIER, device="cuda", seed=0,
    )
    encoding = tennis_encoding(torch, device)
    fused_nerf.fused_adain_nerf.launches = 0
    frames = [session.start(encoding)]
    step_ms = []
    for i in range(STEPS):
        start = time.perf_counter()
        frames.append(session.step(list(ACTIONS[i % len(ACTIONS)])))
        step_ms.append((time.perf_counter() - start) * 1e3)
    launches = fused_nerf.fused_adain_nerf.launches
    for i, frame in enumerate(frames):
        if frame.shape != (IMAGE_SIZE[0], IMAGE_SIZE[1], 3):
            return fail(f"frame {i} has shape {frame.shape}")
        if not np.isfinite(frame).all() or frame.min() < 0.0 or frame.max() > 1.0:
            return fail(f"frame {i} is not finite or leaves [0, 1]")
    if launches != 4 * len(frames):
        return fail(f"{launches} kernel launches for {len(frames)} frames, expected 4 per frame")
    steady = step_ms[2:]
    frame_ms = statistics.median(steady)
    print(
        f"play loop 512x288: {len(frames)} frames, {launches} kernel launches; "
        f"median step {frame_ms:.3f} ms ({1e3 / frame_ms:.2f} fps) over steps 3-{STEPS}; "
        f"all steps ms {[round(t, 3) for t in step_ms]}"
    )

    # ---- report -----------------------------------------------------------
    total = {k: sum(s[k] for s in shapes) for k in ("ms", "plain_ms", "library_ms", "bound_ms", "gflop", "mbytes")}
    bound_by = "operations" if total["gflop"] * 1e9 / PEAK_BF16_FLOPS > total["mbytes"] * 1e6 / PEAK_BYTES_PER_S else "bytes"
    kernels = [{
        "name": "fused_adain_nerf",
        "route": "cuda",
        "source": "playableenvironments_tpu_torch/csrc/fused_nerf.cu",
        "replaces": "playableenvironments_tpu/ops/fused_nerf.py:111",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": bound_by,
        "library_ms": total["library_ms"],
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "shapes": shapes, "step_ms": step_ms,
                   "frame_ms": frame_ms, "kernels": kernels}, f, indent=1)
    print(
        "tf32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} (PyTorch defaults; the port sets neither)"
    )
    print("kernel ms/plain_ms/library_ms/bound_ms are per-frame sums over the four launch shapes")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
