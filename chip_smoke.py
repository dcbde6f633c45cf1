#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: the tennis play loop, the
tennis phase-2 train step and the tennis phase-3 (action module) G+D step.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. build the port's CUDA kernels (csrc/fused_nerf.cu, csrc/fused_backbone.cu,
   csrc/fused_rollout.cu), one nvcc per source, started together;
2. hold the B1 kernel against its plain PyTorch version at the four per-frame
   launch shapes of the tennis scene, and time kernel, plain version, a
   library yardstick (the same MLP as a chain of bf16 torch.matmul, never
   called by the port) and the bound;
3. check a small frame, its composited NeRF features and the dynamics state
   against the same seeded modules on the CPU;
4. drive the main path: configs/tennis.yaml at full width with seeded random
   weights, an InteractiveSession at 512x288 (strides 4 and 8), scripted
   steps for both players; every frame (288, 512, 3), finite, in [0, 1], and
   4 kernel launches per frame;
5. hold the fused backbone's forward (B2) and backward (B3) kernels against
   their plain versions at the four per-step launch shapes of the phase-2
   step and a ragged one, B3 twice on the same inputs (bit-identical), and
   time kernel, plain version, library yardstick and bound, B3's three
   sub-kernels (CUDA events around each) and its scratch and peak memory;
6. one train step of the phase-2 scene at 48x64 on the card and on the CPU
   from the same seeded weights, randomness off: loss, metrics, gradients,
   updated parameters and running statistics;
7. drive the phase-2 main path: bench.py's step (tennis at full width, bf16
   fused backbone, bs 8 x 4 observations x 144 weighted rays at 288x512,
   Adam) for 6 steps with seeded random weights; finite losses and
   parameters, parameters and running statistics moved, 4 B2 and 4 B3
   launches per step, the median step time and the peak memory;
8. hold the dynamics rollout's forward (B4) and backward (B5) kernels
   against their plain versions at the phase-3 shape (16 x 9, F 256, 2
   layers), a ragged 5 x 6 batch for each other RolloutConfig branch and the
   play loop's 1 x 128 dynamics, B5 twice (bit-identical), and time kernel,
   plain version and bound, B5's two kernels apart (CUDA events around
   each), and each case's cluster size, shared memory and how many of its
   clusters the card places at once (cudaOccupancyMaxActiveClusters);
9. one phase-3 G+D step at full width on the card and on the CPU from the
   same seeded weights and the same random draws: loss, metrics, both
   passes' gradients, parameters, running statistics, u/sigma, centroids
   and MI matrices;
10. drive the phase-3 main path: bench.py's fused G+D step (bs 16 x 9
   observations, 2 players, dynamics 2 x 256, action network 3 x 128, GAN
   and ACMV) for 20 steps; finite losses and parameters, both parameter
   groups, the centroids and the MI matrices moved, 4 B4 and 2 B5 launches
   per step, the median step time and the peak memory.
Details go to chiprun_out/chip_smoke.json. Prints one JSON line of kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import json
import math
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


class SmokeFailure(Exception):
    """A failed check of phases 5-10 (main() reports it and exits 1)."""


# ---- phase-2 training (phases 5-7) -------------------------------------------

# B2 (fused backbone forward) vs its plain version: as for B1 (KERNEL_ATOL
# and the rest above): same bf16 operand rounding, f32 sums in another order.
# B3 (backward) vs plain_backbone_bwd, each output relative to its own
# largest magnitude. The other summation order flips an occasional bf16
# rounding of an activation or a cotangent, and, more rarely, a ReLU mask
# at an activation that close to 0; a flipped mask changes one point's
# gradient by that unit's whole contribution (scripts/backbone_grad_noise.py
# measures both versions against f64 sums). d_encoded is per point, so a
# flip shows in full: 1.0e-1 of the largest magnitude on this card at
# 18,432 points and 1.9e-1 at 147,456, with a mean error of 6e-5 of it.
# It is held to 0.5 of the largest magnitude element-wise and 1e-3 in the mean. Weight and bias
# gradients sum such changes over all points, with random-sign cotangents
# that cancel: against the same products summed in f64, the plain f32
# version itself is off by up to ~1e-2 of the largest magnitude (mean
# ~2e-3), and the kernel by about as much, so kernel vs plain is held to
# 5e-2 element-wise and 1e-2 in the mean.
D_ENCODED_REL_ATOL, D_ENCODED_REL_MEAN = 0.5, 1e-3
GRAD_REL_ATOL, GRAD_REL_MEAN = 5e-2, 1e-2
# Per-step launch shapes of the phase-2 step (bs 8 x 4 obs x 144 rays =
# 4,608 rays): (object, points), one B2 and one B3 launch each.
PHASE2_LAUNCHES = (("background", 4608 * 4), ("backplate", 4608 * 4),
                   ("player_1", 4608 * 32), ("player_2", 4608 * 32))
PHASE2_RAGGED = 1000  # not a multiple of the kernels' 128-point tile
PHASE2_STEPS = 6


def phase2_scene():
    """bench.py's phase-2 scene (its build_scene with the overrides of
    _phase2_setup), copied: the published tennis model at full width,
    8x256 NeRFs with 3 outputs and sigmoid activation, bf16 NeRF and bender
    matmuls, the fused backbone, every ray evaluated by every object."""
    import dataclasses

    from playableenvironments_tpu_torch.config import (
        NerfMLPConfig, ObjectEncoderConfig, ObjectModelConfig, ParameterEncoderConfig,
        PositionalEncoderConfig, RayBenderConfig, SceneConfig,
    )

    def obj(name, box, samples, bent):
        bender = (RayBenderConfig(kind="positional", layers_width=128, layers_count=6, skip_layer_idx=3,
                                  position_encoder=PositionalEncoderConfig(octaves=6, num_steps=60000),
                                  compute_dtype="bfloat16")
                  if bent else RayBenderConfig(kind="zeroed", compute_dtype="bfloat16"))
        return ObjectModelConfig(
            name=name, bounding_box=box, positions_count_coarse=samples, ray_compaction=1.0,
            z_near_min=5.0, z_far_max=70.0,
            nerf=NerfMLPConfig(layers_width=256, backbone_layers_count=8, output_features=3, skip_layer_idx=4,
                               position_encoder=PositionalEncoderConfig(octaves=10),
                               compute_dtype="bfloat16", use_fused_backbone=True),
            bender=bender, style_features=64, deformation_features=32,
        )

    static_range = (((0.0, 0.0),) * 3,)
    player_range = (((-7.5, 7.5), (-20.0, 0.0), (0.01, 0.01)),)
    scene = SceneConfig(
        object_models=(
            obj("background", ((-30.0, 30.0), (-40.0, 20.585), (-0.5, 0.0)), 4, False),
            obj("backplate", ((-30.0, 30.0), (0.0, 0.5), (0.0, 30.0)), 4, False),
            obj("player_1", ((-0.75, 0.75), (-0.5, 0.5), (0.0, 2.15)), 32, True),
            obj("player_2", ((-0.75, 0.75), (-0.5, 0.5), (0.0, 2.15)), 32, True),
        ),
        parameter_encoders=(
            ParameterEncoderConfig(kind="static", translation_range=static_range, rotation_range=static_range),
            ParameterEncoderConfig(kind="static", translation_range=static_range, rotation_range=static_range),
            ParameterEncoderConfig(kind="classic", translation_range=player_range, rotation_range=static_range),
            ParameterEncoderConfig(kind="classic", translation_range=player_range, rotation_range=static_range),
        ),
        object_encoders=(
            ObjectEncoderConfig(kind="v5", input_size=(64, 256)),
            ObjectEncoderConfig(kind="v5", input_size=(32, 256)),
            ObjectEncoderConfig(kind="v4", input_size=(64, 64)),
            ObjectEncoderConfig(kind="v4", input_size=(64, 64)),
        ),
        static_object_models=2,
        apply_activation=True,
        sampling_weights=(0.55, 0.15, 0.15, 0.15),
    )
    return scene


def phase2_batch(torch, bs, obs, height, width, device):
    """bench.py's phase-2 batch (_phase2_setup), copied: random frames from
    numpy seed 0, the camera 18 m behind and 10 m above the court looking
    down 0.65 rad, focal 1180 px at 1920 wide, two player boxes."""
    import numpy as np

    from playableenvironments_tpu_torch.data.batching import Batch

    cams = 1
    rng = np.random.default_rng(0)
    rotations = torch.zeros(bs, obs, cams, 3)
    rotations[..., 0] = -0.65
    translations = torch.zeros(bs, obs, cams, 3)
    translations[..., 1], translations[..., 2] = 18.0, 10.0
    frames = torch.zeros(bs, obs, dtype=torch.int32)
    boxes = torch.tensor([[0.3, 0.4, 0.38, 0.55], [0.6, 0.5, 0.68, 0.66]]).expand(bs, obs, cams, 2, 4)
    return Batch(
        observations=torch.from_numpy(rng.random((bs, obs, cams, height, width, 3), np.float32)),
        camera_rotations=rotations, camera_translations=translations,
        focals=torch.full((bs, obs, cams), 1180.0 * width / 1920.0),
        bounding_boxes=boxes.contiguous(), bounding_boxes_validity=torch.ones(bs, obs, cams, 2, dtype=torch.bool),
        global_frame_indexes=frames, video_frame_indexes=frames, video_indexes=torch.zeros(bs, dtype=torch.int32),
    ).to(device)


def backbone_work(cfg, pe: int, points: int):
    """(forward flops, forward bytes, backward flops, backward bytes) of the
    fused backbone over `points` points: each input read once (f32
    encodings, cotangents, f32 weights), each output written once; the
    backward recomputes the forward and forms input and weight gradients,
    three times the forward's products."""
    from playableenvironments_tpu_torch.ops import fused_nerf

    width = cfg.layers_width
    macs = sum(w_in * width for w_in in fused_nerf._backbone_sizes(cfg, pe)) + width
    weight_bytes = 4 * (macs + width * cfg.backbone_layers_count + 1)
    fwd_flops = 2.0 * macs * points
    fwd_bytes = points * 4 * (pe + width + 1) + weight_bytes
    bwd_bytes = points * 4 * (pe + width + 1 + pe) + 2 * weight_bytes
    return fwd_flops, fwd_bytes, 3 * fwd_flops, bwd_bytes


def library_backbone(torch, cfg, bf, encoded):
    """The backbone + alpha head as a chain of bf16 torch.matmul calls over
    bf16 weights `bf` (requiring grad): the yardstick `library_ms` of B2,
    and its torch.autograd backward that of B3. Timed only; the port never
    calls it."""
    enc = encoded.to(torch.bfloat16)
    h = enc
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx:
            h = torch.cat([h, enc], dim=-1)
        h = torch.relu(h @ bf[f"w{i}"] + bf[f"b{i}"])
    return h, (h @ bf["w_alpha"] + bf["b_alpha"])[:, 0]


def check_close(name, got, ref, atol, rtol, mean_atol):
    """(max, mean) abs error of `got` against `ref`; raises unless every
    element is within atol + rtol |ref| and the mean within mean_atol."""
    import torch

    diff = (got - ref).abs()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} or non-finite values")
    if not bool((diff <= atol + rtol * ref.abs()).all()) or not diff.mean().item() <= mean_atol:
        raise SmokeFailure(f"{name}: differs from its plain version by up to {diff.max().item():.3e}, "
                           f"{diff.mean().item():.3e} on average")
    return diff.max().item(), diff.mean().item()


def phase5_inputs(points: int, seed: int = 2):
    """(cfg, packed weights, encodings, g_h, g_alpha) on the card for one
    B2/B3 launch at the tennis widths: seeded random weights (biases
    non-zero, so that no ReLU input is exactly 0), PE of random points in
    [-1, 1], random cotangents."""
    import torch

    from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig
    from playableenvironments_tpu_torch.models.encoding import positional_encoding
    from playableenvironments_tpu_torch.models.layers import initialize_
    from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP

    cfg = NerfMLPConfig(layers_width=256, backbone_layers_count=8, output_features=3, skip_layer_idx=4,
                        position_encoder=PositionalEncoderConfig(octaves=10), compute_dtype="bfloat16",
                        use_fused_backbone=True)
    generator = torch.Generator().manual_seed(seed)
    nerf = initialize_(AdaInNerfMLP(cfg, 64, device="cuda"), generator)
    with torch.no_grad():
        for i in range(cfg.backbone_layers_count):
            getattr(nerf, f"backbone_{i}").bias.copy_(torch.randn(256, generator=generator) * 0.1)
    packed = {k: v.detach().contiguous() for k, v in nerf.backbone_params().items()}
    encoded = positional_encoding(torch.rand(points, 3, generator=generator) * 2.0 - 1.0, 10, True).cuda()
    g_h = (torch.randn(points, 256, generator=generator) * 1e-3).cuda()
    g_alpha = (torch.randn(points, generator=generator) * 1e-3).cuda()
    return cfg, packed, encoded, g_h, g_alpha


def phase5_backbone_kernels():
    """B2 and B3 at the phase-2 launch shapes and a ragged one, against
    plain_backbone_fwd / plain_backbone_bwd; B3 twice, bit-identical; times."""
    import torch

    from playableenvironments_tpu_torch.ops import fused_nerf

    fwd_rows, bwd_rows = [], []
    for index, (name, points) in enumerate(PHASE2_LAUNCHES + (("ragged", PHASE2_RAGGED),)):
        cfg, packed, encoded, g_h, g_alpha = phase5_inputs(points, seed=2 + index)
        bf = {k: v.to(torch.bfloat16).requires_grad_() for k, v in packed.items()}
        saved = encoded.to(torch.bfloat16)  # the encodings as the autograd Function saves them for B3
        pe = encoded.shape[1]
        with torch.no_grad():
            h, alpha = fused_nerf.fused_backbone_fwd(cfg, packed, encoded)
            torch.cuda.synchronize()
            ref_h, ref_alpha = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
            err_h = check_close(f"B2 {name} h", h, ref_h, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
            err_a = check_close(f"B2 {name} alpha", alpha, ref_alpha, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
            grads, d_enc = fused_nerf.fused_backbone_bwd(cfg, packed, saved, g_h, g_alpha)
            again, d_enc_again = fused_nerf.fused_backbone_bwd(cfg, packed, saved, g_h, g_alpha)
            torch.cuda.synchronize()
            identical = torch.equal(d_enc, d_enc_again) and all(torch.equal(grads[k], again[k]) for k in grads)
            if not identical:
                raise SmokeFailure(f"B3 {name}: two launches on the same inputs differ")
            ref_grads, ref_d_enc = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
            worst, worst_mean, errs = 0.0, 0.0, {}
            for key, got, ref in [("d_encoded", d_enc, ref_d_enc)] + [(k, grads[k], ref_grads[k]) for k in ref_grads]:
                scale = ref.abs().max().item()
                tol, mean_tol = ((D_ENCODED_REL_ATOL, D_ENCODED_REL_MEAN) if key == "d_encoded"
                                 else (GRAD_REL_ATOL, GRAD_REL_MEAN))
                err, mean = check_close(f"B3 {name} {key}", got, ref, tol * scale, 0.0, mean_tol * scale)
                errs[key] = (err / scale, mean / scale)
                worst, worst_mean = max(worst, err / scale), max(worst_mean, mean / scale)
        fwd_flops, fwd_bytes, bwd_flops, bwd_bytes = backbone_work(cfg, pe, points)
        row = {"object": name, "points": points}
        if name != "ragged":
            # Timed as the autograd Function calls them: the forward builds the
            # weight image, the backward takes the forward's and the saved bf16
            # encodings. kernel_ms leaves
            # the image's build and the wrapper out: B2 on a prebuilt image, B3
            # the sum of CUDA events around its three kernels.
            with torch.no_grad():
                buffers = fused_nerf.backbone_buffers(cfg, packed)
                ms = cuda_ms(lambda: fused_nerf.fused_backbone_fwd(cfg, packed, encoded))
                kernel_ms = cuda_ms(lambda: fused_nerf.fused_backbone_fwd(cfg, packed, encoded, buffers))
                plain_ms = cuda_ms(lambda: fused_nerf.plain_backbone_fwd(cfg, packed, encoded))
                library_ms = cuda_ms(lambda: library_backbone(torch, cfg, bf, encoded))
                bwd_ms = cuda_ms(lambda: fused_nerf.fused_backbone_bwd(cfg, packed, saved, g_h, g_alpha, buffers))
                bwd_plain_ms = cuda_ms(lambda: fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha))
            lib_h, lib_alpha = library_backbone(torch, cfg, bf, encoded)
            cot = [g_h.to(torch.bfloat16), g_alpha.to(torch.bfloat16)]
            bwd_library_ms = cuda_ms(lambda: torch.autograd.backward([lib_h, lib_alpha], cot, retain_graph=True))
            for b in bf.values():
                b.grad = None
            del lib_h, lib_alpha
            breakdown = [fused_nerf.backbone_bwd_breakdown(cfg, packed, saved, g_h, g_alpha) for _ in range(7)]
            sub_ms = {k: statistics.median(b[k] for b in breakdown) for k in breakdown[0]}
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            shapes = fused_nerf.backbone_scratch_shapes(cfg, points, sms)
            scratch_bytes = sum(math.prod(v) * (2 if k in ("x", "g") else 4) for k, v in shapes.items())
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fused_nerf.fused_backbone_bwd(cfg, packed, saved, g_h, g_alpha, buffers)
            torch.cuda.synchronize()
            peak_bytes = torch.cuda.max_memory_allocated() - base
            fwd_rows.append(dict(row, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=max(fwd_flops / PEAK_BF16_FLOPS, fwd_bytes / PEAK_BYTES_PER_S) * 1e3,
                                 gflop=fwd_flops / 1e9, mbytes=fwd_bytes / 1e6,
                                 max_abs_err=max(err_h[0], err_a[0]), mean_abs_err=max(err_h[1], err_a[1])))
            bwd_rows.append(dict(row, ms=bwd_ms, kernel_ms=sum(sub_ms.values()), plain_ms=bwd_plain_ms,
                                 library_ms=bwd_library_ms,
                                 bound_ms=max(bwd_flops / PEAK_BF16_FLOPS, bwd_bytes / PEAK_BYTES_PER_S) * 1e3,
                                 gflop=bwd_flops / 1e9, mbytes=bwd_bytes / 1e6,
                                 max_abs_err=worst, mean_abs_err=worst_mean, errors=errs,
                                 sub_kernel_ms=sub_ms, scratch_bytes=scratch_bytes, peak_bytes=peak_bytes))
            total = sum(sub_ms.values())
            print(f"B2 {name} ({points} points): max abs err {fwd_rows[-1]['max_abs_err']:.3e}, mean "
                  f"{fwd_rows[-1]['mean_abs_err']:.3e}; call {ms:.4f} ms (kernel {kernel_ms:.4f} ms, "
                  f"{fwd_flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
                  f"bound {fwd_rows[-1]['bound_ms']:.4f} ms")
            print(f"B3 {name} ({points} points): bit-identical across two launches; max err {worst:.3e} and mean "
                  f"err {worst_mean:.3e} of each output's largest magnitude; call {bwd_ms:.4f} ms (kernels "
                  f"{total:.4f} ms, {bwd_flops / total / 1e9:.1f} TFLOP/s), plain {bwd_plain_ms:.4f} ms, library "
                  f"{bwd_library_ms:.4f} ms, bound {bwd_rows[-1]['bound_ms']:.4f} ms; d_encoded err "
                  f"{errs['d_encoded'][0]:.3e} (mean {errs['d_encoded'][1]:.3e}), weights' worst "
                  f"{max(v[0] for k, v in errs.items() if k != 'd_encoded'):.3e} (mean "
                  f"{max(v[1] for k, v in errs.items() if k != 'd_encoded'):.3e})")
            print(f"B3 {name} ({points} points) sub-kernels, CUDA events around each (median of 7): "
                  + ", ".join(f"{k[:-3]} {v:.4f} ms ({100 * v / total:.1f}%)" for k, v in sub_ms.items())
                  + f"; scratch {scratch_bytes / 2**20:.1f} MiB allocated by the wrapper, peak memory "
                  f"{peak_bytes / 2**20:.1f} MiB above the inputs during one launch")
        else:
            print(f"B2/B3 ragged ({points} points, not a multiple of 128): B2 max abs err "
                  f"{max(err_h[0], err_a[0]):.3e}; B3 bit-identical, max err {worst:.3e} of scale")
    return fwd_rows, bwd_rows


def _train_step_outputs(torch, trainer, batch, rng):
    """(loss, metrics, grads, parameters and running statistics after) of one step."""
    model = trainer.model
    model.train()
    trainer.optimizer.zero_grad()
    loss, metrics, _ = trainer.compute_losses(batch, rng, trainer.step)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    trainer.optimizer.step()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads, state


def phase6_card_vs_cpu(devices=("cuda", "cpu")):
    """One train step of the phase-2 scene at 1 x 2 observations of
    288x512, randomness off (the strided grid of strides 8 and 16, 2,880
    rays an image; no perturbation, no style shuffle), on the card and on
    the CPU from the same seeded weights. (Weighted sampling draws the same
    numbers on both devices, but its inverse CDF, a cumulative sum over
    147,456 pixels taken in another order on the card, moves a few draws to
    a neighbouring pixel.)"""
    import torch

    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
    from playableenvironments_tpu_torch.train.trainer_synthesis import (
        LossWeights, SynthesisTrainer, SynthesisTrainingConfig,
    )
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cfg = SynthesisTrainingConfig(
        samples_per_image=0, patch_strides=(8, 16), perturb=False, shuffle_style=False,
        loss_weights=LossWeights(reconstruction=1.0, opacity=0.01, attention=0.01, bounding_box=0.1),
    )
    outputs = []
    for device in devices:
        model = EnvironmentModel(phase2_scene(), device=device, seed=3)
        batch = phase2_batch(torch, 1, 2, 288, 512, device)
        outputs.append(_train_step_outputs(torch, SynthesisTrainer(model, cfg), batch, RngStreams(0, device)))
    (loss, metrics, grads, state), (ref_loss, ref_metrics, ref_grads, ref_state) = outputs
    # The card runs B2/B3 (bf16 roundings that flip against the CPU's; see
    # GRAD_REL_ATOL) and the encoders' convolutions in TF32 (PyTorch's
    # default for cuDNN, which the port leaves alone). Loss and metrics are
    # held to 1e-3 relative. Gradients: the backplate's encoder normalizes,
    # in its last blocks, 16 values a channel (1 x 8 maps of 2 crops), so
    # TF32's ~1e-3 relative error in a convolution comes out amplified, and
    # measured on the card reached 1.0e-1 of that encoder's largest gradient
    # in single elements, with mean errors up to 4.8e-2 of a tensor's own
    # largest magnitude. So each gradient tensor is held to 0.25 of the
    # largest gradient magnitude of its model (object_model_i or
    # object_encoder_i) element-wise, and to 0.1 of its own largest
    # magnitude in the mean. The running statistics, batch means and
    # variances of bf16 products on both sides, to 2e-2 of each buffer's
    # largest magnitude (a mean near 0 is a difference of near-equal sums).
    # Parameters after the step: Adam's first update is lr g / (|g| + 1e-8),
    # about lr sign(g) where |g| >> 1e-8, so every element whose CPU gradient
    # exceeds 1e-5 and twice its tensor's largest card-vs-CPU gradient error
    # (a sign the noise cannot flip) is held to 1e-6 + 1e-4 relative, and
    # every element to 2 lr.
    worst = {}
    for name, got in list(metrics.items()) + [("loss", loss)]:
        ref = ref_metrics.get(name, ref_loss)
        if not abs(got.item() - ref.item()) <= 1e-3 * abs(ref.item()) + 1e-6:
            raise SmokeFailure(f"card vs CPU {name}: {got.item():.6e} vs {ref.item():.6e}")
    if set(grads) != set(ref_grads):
        raise SmokeFailure("card vs CPU: different parameters received gradients")

    def group(name):
        parts = name.split(".")
        return ".".join(parts[:2]) if parts[0] == "composer" else parts[0]

    group_scale = {}
    for name, ref in ref_grads.items():
        group_scale[group(name)] = max(group_scale.get(group(name), 0.0), ref.abs().max().item())
    rel, grad_noise = [], {}
    for name, got in grads.items():
        ref = ref_grads[name]
        diff = (got.cpu() - ref).abs()
        grad_noise[name] = diff.max().item()
        scale = max(ref.abs().max().item(), 1e-30)
        rel.append((diff.max().item() / max(group_scale[group(name)], 1e-30), diff.mean().item() / scale, name))
    rel.sort(reverse=True)
    for r in rel[:4]:
        print(f"  card vs CPU gradient {r[2]}: max err {r[0]:.3e} of its model's largest gradient, "
              f"mean err {r[1]:.3e} of its own")
    grad_err = rel[0][0]
    grad_mean_err = max(r[1] for r in rel)
    problems = [f"gradient {r[2]}: max err {r[0]:.3e} of its model's largest gradient, mean err {r[1]:.3e} "
                "of its own" for r in rel if not (r[0] <= 0.25 and r[1] <= 0.1)]
    lr = cfg.learning_rate
    param_err = stats_err = 0.0
    clear_count = 0
    for name, got in state.items():
        got, ref = got.cpu(), ref_state[name]
        diff = (got - ref).abs()
        if name in ref_grads:
            clear = ref_grads[name].abs() > max(2 * grad_noise[name], 1e-5)
            clear_count += int(clear.sum())
            if not bool((diff[clear] <= 1e-6 + 1e-4 * ref[clear].abs()).all()) or not diff.max().item() <= 2 * lr + 1e-6:
                problems.append(f"parameter {name} after the step: err {diff.max().item():.3e}, "
                                f"{diff[clear].max().item() if clear.any() else 0.0:.3e} where the sign is clear")
            param_err = max(param_err, diff[clear].max().item() if clear.any() else 0.0)
        elif got.dtype.is_floating_point:
            scale = max(ref.abs().max().item(), 1e-30)
            if not diff.max().item() <= 2e-2 * scale:
                problems.append(f"running statistic {name}: err {diff.max().item() / scale:.3e} of its largest")
            stats_err = max(stats_err, diff.max().item() / scale)
    if problems:
        for problem in problems[:12]:
            print(f"  card vs CPU: {problem}")
        raise SmokeFailure(f"card vs CPU train step: {len(problems)} checks failed, first: {problems[0]}")
    worst.update(loss=loss.item(), ref_loss=ref_loss.item(), grad_rel_err=grad_err, grad_mean_rel_err=grad_mean_err,
                 param_err=param_err, sign_clear_elements=clear_count, stats_err=stats_err, grads=len(grads))
    print(f"train step card vs CPU (phase-2 scene, 1 x 2 obs, 288x512, strides 8/16): loss {loss.item():.6f} "
          f"vs {ref_loss.item():.6f}; {len(grads)} gradient tensors within {grad_err:.3e} of their model's "
          f"largest gradient (mean error up to {grad_mean_err:.3e} of their own); {clear_count} parameter "
          f"elements with a clear gradient sign within {param_err:.3e} after the step; running statistics "
          f"within {stats_err:.3e} of their largest magnitude")
    return worst


def phase7_main_path():
    """The phase-2 main path: bench.py's step geometry (bs 8, 4 obs, 1
    camera, 288x512, 144 weighted rays an image, perturbation and style
    shuffle on), seeded random weights, PHASE2_STEPS steps."""
    import statistics as stats_lib

    import torch

    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
    from playableenvironments_tpu_torch.train.trainer_synthesis import (
        LossWeights, SynthesisTrainer, SynthesisTrainingConfig,
    )
    from playableenvironments_tpu_torch.utils.random import RngStreams

    device = "cuda"
    model = EnvironmentModel(phase2_scene(), focal_length_multiplier=1.0, device=device, seed=0)
    trainer = SynthesisTrainer(model, SynthesisTrainingConfig(
        samples_per_image=144,
        loss_weights=LossWeights(reconstruction=1.0, opacity=0.01, attention=0.01, bounding_box=0.1),
    ))
    batch = phase2_batch(torch, 8, 4, 288, 512, device)
    rng = RngStreams(0, device)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_nerf.fused_backbone_fwd.launches = 0
    fused_nerf.fused_backbone_bwd.launches = 0
    step_ms, losses = [], []
    for _ in range(PHASE2_STEPS):
        start = time.perf_counter()
        metrics = trainer.train_step(batch, rng)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        losses.append(metrics["loss"].item())
    launches = (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"phase-2 step losses {losses}")
    params = dict(model.named_parameters())
    for name, p in params.items():
        if not bool(torch.isfinite(p).all()):
            raise SmokeFailure(f"parameter {name} is not finite after {PHASE2_STEPS} steps")
    state = model.state_dict()
    moved_params = sum(not torch.equal(state[n], before[n]) for n in params)
    stats_names = [n for n in state if n not in params]
    moved_stats = sum(not torch.equal(state[n], before[n]) for n in stats_names)
    if moved_params < 0.95 * len(params) or moved_stats < len(stats_names):
        raise SmokeFailure(f"{moved_params}/{len(params)} parameters and {moved_stats}/{len(stats_names)} "
                           "running statistics moved")
    if launches != (4 * PHASE2_STEPS, 4 * PHASE2_STEPS):
        raise SmokeFailure(f"B2/B3 launches {launches} in {PHASE2_STEPS} steps, expected 4 each per step")
    median = stats_lib.median(step_ms[2:])
    print(f"phase-2 train step (bs 8 x 4 obs x 144 rays, 288x512, bf16 fused backbone): {PHASE2_STEPS} steps, "
          f"B2 {launches[0]} and B3 {launches[1]} launches; median step {median:.3f} ms over steps 3-{PHASE2_STEPS}; "
          f"all steps ms {[round(t, 3) for t in step_ms]}; losses {[round(x, 6) for x in losses]}; "
          f"{moved_params}/{len(params)} parameters and {moved_stats}/{len(stats_names)} running statistics moved; "
          f"peak memory {peak / 2**30:.3f} GiB")
    return {"launches": launches, "step_ms": step_ms, "median_step_ms": median, "losses": losses,
            "peak_memory_bytes": peak}


# ---- phase-3 training (phases 8-10) -------------------------------------------

# B4/B5 compute in f32 on the CUDA cores, as the JAX reference does, so their
# bound uses the card's f32 peak outside the tensor cores (H100 SXM data
# sheet), not the bf16 one.
PEAK_F32_FLOPS = 67e12
# B4/B5 vs their plain versions on the card: both f32, differing only in the
# order of the sums (a fixed k order per column in the kernels, cuBLAS's
# blocking in the plain version; the weight gradients summed over all rows
# at once instead of step by step). f32 rounding of sums of up to 1,024
# terms is ~1e-6 of their magnitude, carried through T-1 = 8 recurrent
# steps. Each output is held to 1e-4 of its largest magnitude element-wise
# and 1e-5 in the mean.
ROLLOUT_REL_ATOL, ROLLOUT_REL_MEAN = 1e-4, 1e-5
PHASE3_BATCH, PHASE3_OBSERVATIONS, PHASE3_GT = 16, 9, 5
PHASE3_STEPS = 20


def phase3_animation_config():
    """bench.py's _phase3_animation_config, copied: the published tennis
    animation-model sizes (dynamics 2 LSTM layers of 256, action network
    3 x 128, 7 actions, 5-dimensional action space, soft gumbel at
    temperature 1, centroid alpha 0.1)."""
    from playableenvironments_tpu_torch.config import (
        ActionNetworkConfig, AnimationModelConfig, DynamicsNetworkConfig,
    )

    return AnimationModelConfig(
        actions_count=7, action_space_dimension=5, style_features=64, deformation_features=32,
        gumbel_temperature=1.0, hard_gumbel=False, centroid_alpha=0.1,
        dynamics=DynamicsNetworkConfig(output_features=256, layers_count=2, force_rotations_zero=True,
                                       force_z_translations_zero=True, rotation_axis=2),
        action_network=ActionNetworkConfig(layers_width=128, layers_count=3),
    )


def rollout_work(batch, T, params, A, V, S, D, collect):
    """(forward flops, forward bytes, backward flops, backward bytes) of one
    rollout launch from its shapes. Per row and step the forward multiplies
    the input block by each layer's wx and wh, then by wb and whead; the
    backward repeats those products for the input gradients and once more
    for the weight gradients. Bytes: each input read once (f32 weights,
    states, actions, variations; the backward's residuals and cotangents),
    each output written once (states; residuals when collected; the
    backward's parameter and input gradients)."""
    F = params.wb.shape[0]
    macs = sum(w.shape[0] * w.shape[1] for w in params.wx + params.wh) + F * F + F * params.whead.shape[1]
    rows = batch * (T - 1)
    weights = 4 * sum(p.numel() for p in (list(params.wx) + list(params.wh) + list(params.bh) + list(params.h_init)
                                          + list(params.c_init) + [params.wb, params.bb, params.whead, params.bhead]))
    state = 4 * batch * T * (6 + S + D)
    act = 4 * rows * (A + V)
    residuals = 4 * rows * (6 + S + D + params.wx[0].shape[0] + F + params.whead.shape[1] + len(params.wx) * 6 * F)
    fwd_flops = 2.0 * macs * rows
    fwd_bytes = weights + state + act + state + (residuals if collect else 0)
    bwd_bytes = weights + residuals + state + weights + state + act
    return fwd_flops, fwd_bytes, 2 * fwd_flops, bwd_bytes


def bound_ms(flops, bytes_):
    """(ms, bound_by) at the f32 peak and the memory rate."""
    ops, mem = flops / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES_PER_S
    return max(ops, mem) * 1e3, ("operations" if ops > mem else "bytes")


def rollout_case(anim, box, batch, T, seed, device):
    """Seeded DynamicsNetwork weights (biases and initial states non-zero),
    packed as the main path packs them (the backbone weight a transposed
    view), and seeded inputs and cotangents, on `device`."""
    import torch

    from playableenvironments_tpu_torch.models.dynamics import DynamicsNetwork
    from playableenvironments_tpu_torch.models.layers import initialize_
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    g = torch.Generator().manual_seed(seed)
    dyn = initialize_(DynamicsNetwork(anim, box), g)
    with torch.no_grad():
        for name, p in dyn.named_parameters():
            if name.endswith("bias") or name.startswith("initial_"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        packed = fr.params_from_list([p.detach().to(device) for p in fr.param_list(fr.pack_dynamics_params(dyn))],
                                     anim.dynamics.layers_count)
    S, D, A, V = anim.style_features, anim.deformation_features, anim.actions_count, anim.action_space_dimension
    inputs = [torch.randn(batch, T, 3, generator=g) * 0.3, torch.randn(batch, T, 3, generator=g),
              torch.randn(batch, T, S, generator=g), torch.randn(batch, T, D, generator=g),
              torch.softmax(torch.randn(batch, T - 1, A, generator=g), dim=-1),
              torch.randn(batch, T - 1, V, generator=g) * 0.1]
    cots = [torch.randn(batch, T, w, generator=g) for w in (3, 3, S, D)]
    return packed, [x.to(device) for x in inputs], [c.to(device) for c in cots]


def rel_close(name, got, ref, atol=ROLLOUT_REL_ATOL, mean=ROLLOUT_REL_MEAN):
    """Max and mean error of `got` relative to the largest magnitude of `ref`."""
    scale = max(ref.abs().max().item(), 1e-30)
    err, mean_err = check_close(name, got, ref, atol * scale, 0.0, mean * scale)
    return err / scale, mean_err / scale


def phase8_rollout_kernels(device="cuda"):
    """B4 and B5 against their plain versions on the card: the phase-3 shape
    (16 x 9, F 256, 2 layers, the tennis branch: rotations forced to zero,
    axis 2, the axis translation forced to 0), a ragged batch of 5 x 6 for
    each of the other two branches, and the play loop's 1 x 128 dynamics;
    B5 twice on the same inputs (bit-identical); times at the phase-3 shape."""
    import torch

    from playableenvironments_tpu_torch.config import scene_from_yaml
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    repo = os.path.dirname(os.path.abspath(__file__))
    box = ((-0.75, 0.75), (-0.5, 0.5), (0.0, 2.15))
    box_size = tuple(hi - lo for lo, hi in box)
    anim = phase3_animation_config()
    play_anim = scene_from_yaml(os.path.join(repo, "configs", "tennis.yaml")).animation_models[0]
    cases = [
        ("phase-3", anim, PHASE3_BATCH, PHASE3_OBSERVATIONS, fr.RolloutConfig(2, True, 0.0, box_size), PHASE3_GT),
        ("ragged, axis 1, free", anim, 5, 6, fr.RolloutConfig(1, False, None, box_size), 1),
        ("ragged, axis 0, forced 0.01", anim, 5, 6, fr.RolloutConfig(0, False, 0.01, box_size), 0),
        ("play dynamics", play_anim, PHASE3_BATCH, PHASE3_OBSERVATIONS, fr.RolloutConfig(2, True, 0.0, box_size),
         PHASE3_GT),
    ]
    rows, timing = [], None
    for index, (name, cfg_anim, batch, T, cfg, gt) in enumerate(cases):
        packed, inputs, cots = rollout_case(cfg_anim, box, batch, T, 10 + index, device)
        A = cfg_anim.actions_count
        with torch.no_grad():
            out, res = fr.fused_rollout_fwd(cfg, packed, *inputs, gt, True)
            out_without_res = fr.fused_rollout_fwd(cfg, packed, *inputs, gt, False)[0]
            grads = fr.fused_rollout_bwd(cfg, packed, gt, res, cots, A)
            again = fr.fused_rollout_bwd(cfg, packed, gt, res, cots, A)
            if device == "cuda":
                torch.cuda.synchronize()
            ref_out, ref_res = fr.plain_rollout_fwd(cfg, packed, *inputs, gt, True)
            ref_grads = fr.plain_rollout_bwd(cfg, packed, gt, ref_res, cots, A)
        flat = lambda g: fr.param_list(g[0]) + list(g[1:])  # noqa: E731
        if not all(torch.equal(a, b) for a, b in zip(flat(grads), flat(again))):
            raise SmokeFailure(f"B5 {name}: two launches on the same inputs differ")
        if not all(torch.equal(a, b) for a, b in zip(out, out_without_res)):
            raise SmokeFailure(f"B4 {name}: outputs differ with and without residuals")
        fwd_errs = [rel_close(f"B4 {name} {k}", got, ref) for k, got, ref in
                    zip(("rot", "trans", "style", "deform"), out, ref_out)]
        fwd_errs += [rel_close(f"B4 {name} residual {k}", res[k], ref_res[k]) for k in ref_res]
        bwd_errs = {k: rel_close(f"B5 {name} gradient {k}", got, ref)
                    for k, (got, ref) in enumerate(zip(flat(grads), flat(ref_grads)))}
        row = {"case": name, "batch": batch, "observations": T, "features": packed.wb.shape[0],
               "layers": len(packed.wx), "fwd_max_rel_err": max(e[0] for e in fwd_errs),
               "fwd_mean_rel_err": max(e[1] for e in fwd_errs),
               "bwd_max_rel_err": max(e[0] for e in bwd_errs.values()),
               "bwd_mean_rel_err": max(e[1] for e in bwd_errs.values())}
        if index == 0 and device == "cuda":
            S, D, V = inputs[2].shape[-1], inputs[3].shape[-1], inputs[5].shape[-1]
            ff, fb, bf, bb = rollout_work(batch, T, packed, A, V, S, D, collect=True)
            _, fb_nores, _, _ = rollout_work(batch, T, packed, A, V, S, D, collect=False)
            with torch.no_grad():
                timing = {
                    "fwd_res_ms": cuda_ms(lambda: fr.fused_rollout_fwd(cfg, packed, *inputs, gt, True)),
                    "fwd_ms": cuda_ms(lambda: fr.fused_rollout_fwd(cfg, packed, *inputs, gt, False)),
                    "fwd_res_plain_ms": cuda_ms(lambda: fr.plain_rollout_fwd(cfg, packed, *inputs, gt, True)),
                    "fwd_plain_ms": cuda_ms(lambda: fr.plain_rollout_fwd(cfg, packed, *inputs, gt, False)),
                    "bwd_ms": cuda_ms(lambda: fr.fused_rollout_bwd(cfg, packed, gt, res, cots, A)),
                    "bwd_plain_ms": cuda_ms(lambda: fr.plain_rollout_bwd(cfg, packed, gt, ref_res, cots, A)),
                }
                # The launches apart: CUDA events around each (B4: the image
                # gather, the rollout; B5: the gather, the recurrence, the
                # weight gradients).
                for key, call in (
                        ("fwd_res", lambda: fr.rollout_fwd_breakdown(cfg, packed, inputs, gt, True)),
                        ("fwd", lambda: fr.rollout_fwd_breakdown(cfg, packed, inputs, gt, False)),
                        ("bwd", lambda: fr.rollout_bwd_breakdown(cfg, packed, gt, res, cots, A))):
                    runs = [call() for _ in range(8)][1:]
                    timing.update({f"{key}_{k}": statistics.median(b[k] for b in runs) for k in runs[0]})
            timing.update(
                fwd_res_bound_ms=bound_ms(ff, fb)[0], fwd_bound_ms=bound_ms(ff, fb_nores)[0],
                fwd_bound_by=bound_ms(ff, fb)[1], bwd_bound_ms=bound_ms(bf, bb)[0], bwd_bound_by=bound_ms(bf, bb)[1],
                fwd_mflop=ff / 1e6, fwd_res_mbytes=fb / 1e6, fwd_mbytes=fb_nores / 1e6, bwd_mflop=bf / 1e6,
                bwd_mbytes=bb / 1e6,
            )
            row.update(timing)
        if device == "cuda":
            # The gather of the weight images against its plain version.
            S, D, V = inputs[2].shape[-1], inputs[3].shape[-1], inputs[5].shape[-1]
            layout = fr.rollout_layout(packed.wb.shape[0], len(packed.wx), 9 + S + D + A + V, 9 + S + D)
            with torch.no_grad():
                images = (fr.card_image(packed, S, D, A, V, True), fr.card_image(packed, S, D, A, V, False))
                ref_images = (fr.rollout_fwd_image(packed, layout), fr.rollout_bwd_image(packed, layout))
            if not all(torch.equal(a, b) for a, b in zip(images[0] + images[1:], ref_images[0] + ref_images[1:])):
                raise SmokeFailure(f"B4/B5 {name}: the card's weight images differ from rollout_fwd_image / _bwd_image")
            # The cluster each kernel runs on and how many of them the card
            # places at once with this shared memory.
            for kind, fwd in (("fwd", True), ("bwd", False)):
                n, smem, clusters = fr.max_active_clusters(packed, fwd)
                if clusters < 1:
                    raise SmokeFailure(f"B4/B5 {name}: no {kind} cluster of {n} CTAs with {smem} B places on the card")
                row.update({f"{kind}_cluster": n, f"{kind}_smem_bytes": smem, f"{kind}_max_active_clusters": clusters})
        rows.append(row)
        print(f"B4/B5 {name} ({batch} x {T}, F {row['features']}, {row['layers']} layers): B4 max err "
              f"{row['fwd_max_rel_err']:.3e} (mean {row['fwd_mean_rel_err']:.3e}) of each output's largest "
              f"magnitude, residuals included; B5 bit-identical across two launches, max err "
              f"{row['bwd_max_rel_err']:.3e} (mean {row['bwd_mean_rel_err']:.3e})"
              + (f"; clusters of {row['fwd_cluster']} CTAs, {row['fwd_smem_bytes']} / {row['bwd_smem_bytes']} B "
                 f"shared memory each (B4 / B5), {row['fwd_max_active_clusters']} / "
                 f"{row['bwd_max_active_clusters']} clusters place at once" if device == "cuda" else "")
              + (f"; B4 {timing['fwd_res_ms']:.4f} ms with residuals / {timing['fwd_ms']:.4f} ms without "
                 f"(plain {timing['fwd_res_plain_ms']:.4f} / {timing['fwd_plain_ms']:.4f}, bound "
                 f"{timing['fwd_res_bound_ms']:.4f} / {timing['fwd_bound_ms']:.4f}, {timing['fwd_bound_by']}); "
                 f"B5 {timing['bwd_ms']:.4f} ms (plain {timing['bwd_plain_ms']:.4f}, bound "
                 f"{timing['bwd_bound_ms']:.4f}, {timing['bwd_bound_by']}); the launches alone: B4 gather "
                 f"{timing['fwd_res_image_ms']:.4f} + rollout {timing['fwd_res_kernel_ms']:.4f} ms with residuals, "
                 f"{timing['fwd_image_ms']:.4f} + {timing['fwd_kernel_ms']:.4f} without; B5 gather "
                 f"{timing['bwd_image_ms']:.4f} + recurrence {timing['bwd_recurrence_ms']:.4f} + weight "
                 f"gradients {timing['bwd_wgrad_ms']:.4f} ms"
                 if index == 0 and timing else ""))
    return rows, timing


def phase3_scene():
    """bench.py's _phase3_scene: the published tennis scene with one
    animation model per player. Phase 3 reads the scene's object order,
    bounding boxes and animation models only, which phase2_scene() shares
    with bench.py's build_scene()."""
    import dataclasses

    anim = phase3_animation_config()
    return dataclasses.replace(phase2_scene(), animation_models=(anim, anim))


def phase3_encoding(torch, device):
    """bench.py's phase-3 scene encoding (bench_phase3_step), copied: numpy
    seed 0, bs 16 x 9 observations x 1 camera x 4 objects."""
    import numpy as np

    from playableenvironments_tpu_torch.scene.encoding import SceneEncoding

    bs, T, cams, n_obj = PHASE3_BATCH, PHASE3_OBSERVATIONS, 1, 4
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return SceneEncoding(
        camera_rotations=randn(bs, T, cams, 3) * 0.1, camera_translations=randn(bs, T, cams, 3),
        focals=torch.full((bs, T, cams), 315.0), object_rotations=randn(bs, T, n_obj, 3) * 0.1,
        object_translations=randn(bs, T, n_obj, 3), object_style=randn(bs, T, n_obj, 64),
        object_deformation=randn(bs, T, n_obj, 32), object_in_scene=torch.ones(bs, T, n_obj, dtype=torch.bool),
    ).map(lambda x: x.to(device))


def phase3_trainer(device, seed=3):
    """bench.py's phase-3 trainer (PlayableTrainingConfig with
    ground_truth_observations_start 5, GAN 0.1, ACMV 0.1, every other field
    at its default) over the discriminator-bearing model, seeded weights,
    its state initialized from the encoding."""
    import torch

    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train.trainer_playable import (
        PlayableLossWeights, PlayableTrainer, PlayableTrainingConfig,
    )

    model = PlayableEnvironmentModel(phase3_scene(), with_discriminators=True, device=device, seed=seed)
    trainer = PlayableTrainer(model, PlayableTrainingConfig(
        ground_truth_observations_start=PHASE3_GT, loss_weights=PlayableLossWeights(gan=0.1, acmv=0.1)))
    encoding = phase3_encoding(torch, device)
    trainer.init_state_from_encoding(encoding, seed=0)
    return trainer, encoding


class RecordedStreams:
    """The phase-3 random streams drawn on the CPU, every draw kept so that
    another device can replay the same numbers (ReplayedStreams)."""

    def __init__(self, seed):
        from playableenvironments_tpu_torch.utils.random import RngStreams

        self.streams = RngStreams(seed, "cpu")
        self.draws = []

    def normal(self, stream, shape):
        self.draws.append(self.streams.normal(stream, shape))
        return self.draws[-1]

    def gumbel(self, stream, shape):
        self.draws.append(self.streams.gumbel(stream, shape))
        return self.draws[-1]


class ReplayedStreams:
    def __init__(self, draws, device):
        self.draws, self.device = list(draws), device

    def _next(self, shape):
        value = self.draws.pop(0)
        if tuple(value.shape) != tuple(shape):
            raise SmokeFailure(f"replayed draw of shape {tuple(value.shape)} where {tuple(shape)} is asked for")
        return value.to(self.device)

    def normal(self, stream, shape):
        return self._next(shape)

    gumbel = normal


def _fused_step_outputs(trainer, encoding, rng):
    """(metrics, after G, after D) of one fused step. Each `after` holds the
    gradients of its pass (G's taken where the discriminator step begins,
    D's on the discriminators after it) and the model's state; after G also
    the centroids and MI matrices."""
    model = trainer.playable_model
    after_g = {}
    discriminator_step = trainer.discriminator_step

    def capture(*args):
        after_g.update(grads={n: p.grad.detach().clone() for n, p in model.named_parameters()},
                       state={k: v.detach().clone() for k, v in model.state_dict().items()},
                       extra=[c.clone() for c in trainer.centroids + trainer.mi_matrices])
        return discriminator_step(*args)

    trainer.discriminator_step = capture
    try:
        metrics = trainer.fused_step(encoding, rng)
    finally:
        trainer.discriminator_step = discriminator_step
    after_d = {"grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                         if n.startswith("discriminator")},
               "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    return metrics, after_g, after_d


def _compare_grads(label, grads, ref_grads, problems):
    """Card vs CPU gradients: (max error of any tensor relative to its
    model's largest gradient, largest mean error relative to the tensor's
    own largest, {name: max abs error}); failures go to `problems`."""
    group_scale = {}
    for name, ref in ref_grads.items():
        group = name.split(".")[0]
        group_scale[group] = max(group_scale.get(group, 0.0), ref.abs().max().item())
    worst = worst_mean = 0.0
    worst_name = ""
    noise = {}
    for name, ref in ref_grads.items():
        diff = (grads[name].cpu() - ref).abs()
        noise[name] = diff.max().item()
        group = max(group_scale[name.split(".")[0]], 1e-30)
        rel = noise[name] / group
        # A gradient that is zero but for f32 noise (a bias before a batch
        # norm, mean_fc's bias, which cancels in the direction differences)
        # is judged against its model's scale.
        mean = diff.mean().item() / max(ref.abs().max().item(), 1e-6 * group)
        if mean > worst_mean:
            worst_mean, worst_name = mean, name
        worst = max(worst, rel)
        if not (rel <= 2e-2 and mean <= 1e-2):
            problems.append(f"{label} gradient {name}: max err {rel:.3e} of its model's largest, mean {mean:.3e}")
    return worst, (worst_mean, worst_name), noise


def _compare_parameters(label, state, ref_state, ref_grads, noise, lr, problems):
    """Parameters after an Adam step: where the CPU gradient is clear of the
    card-vs-CPU noise, to 1e-6 + 1e-4 relative; everywhere to 2 lr.
    :return: (max error where the sign is clear, clear elements)."""
    worst, count = 0.0, 0
    for name, ref_grad in ref_grads.items():
        ref = ref_state[name]
        diff = (state[name].cpu() - ref).abs()
        clear = ref_grad.abs() > max(2 * noise[name], 1e-6)
        count += int(clear.sum())
        if clear.any():
            worst = max(worst, diff[clear].max().item())
        if not bool((diff[clear] <= 1e-6 + 1e-4 * ref[clear].abs()).all()) or not diff.max().item() <= 2 * lr + 1e-6:
            problems.append(f"parameter {name} after {label}: err {diff.max().item():.3e}, "
                            f"{diff[clear].max().item() if clear.any() else 0.0:.3e} where the sign is clear")
    return worst, count


def phase9_card_vs_cpu(devices=("cuda", "cpu")):
    """One fused G+D step of bench.py's phase-3 geometry at full width on the
    card and on the CPU from the same seeded weights and the same random
    draws (made on the CPU, handed to both)."""
    import torch

    recorded = RecordedStreams(0)
    outputs = []
    for index, device in enumerate(reversed(devices)):  # the CPU first: it records the draws
        trainer, encoding = phase3_trainer(device)
        rng = recorded if index == 0 else ReplayedStreams(recorded.draws, device)
        outputs.append(_fused_step_outputs(trainer, encoding, rng))
    lr = trainer.cfg.learning_rate
    (ref_metrics, ref_g, ref_d), (metrics, after_g, after_d) = outputs
    # The card runs B4/B5 (f32, sums in another order: ~1e-6, phase 8),
    # cuBLAS's f32 products and the discriminators' convolutions in TF32
    # (PyTorch's default for cuDNN, which the port leaves alone; ~1e-3 of a
    # logit). Loss and metrics are held to 1e-3 relative. Gradients: each
    # tensor to 2e-2 of its model's largest gradient element-wise and 1e-2 of
    # its own largest (at least 1e-6 of its model's) in the mean (measured
    # on the card: 7.1e-4 and 4.9e-3 in the generator pass, 1.8e-3 and
    # 2.1e-3 in the discriminator pass). The running statistics, u/sigma, centroids and MI matrices
    # to 1e-3 of each buffer's largest magnitude. Parameters after each
    # pass: Adam's first step is about lr sign(g), so every element whose CPU
    # gradient exceeds 1e-6 and twice its tensor's card-vs-CPU gradient
    # error is held to 1e-6 + 1e-4 relative, every element to 2 lr.
    problems = []
    for name, ref in ref_metrics.items():
        got = metrics[name].item()
        if not abs(got - ref.item()) <= 1e-3 * abs(ref.item()) + 1e-6:
            problems.append(f"metric {name}: {got:.6e} vs {ref.item():.6e}")
    g_err, g_mean, g_noise = _compare_grads("G", after_g["grads"], ref_g["grads"], problems)
    d_err, d_mean, d_noise = _compare_grads("D", after_d["grads"], ref_d["grads"], problems)
    generator = {n: g for n, g in ref_g["grads"].items() if not n.startswith("discriminator")}
    param_err, clear = _compare_parameters("G", after_g["state"], ref_g["state"], generator, g_noise, lr, problems)
    d_param_err, d_clear = _compare_parameters("D", after_d["state"], ref_d["state"], ref_d["grads"], d_noise, lr,
                                               problems)
    buffer_err = 0.0
    for label, state, ref_state in (("G", after_g["state"], ref_g["state"]), ("D", after_d["state"], ref_d["state"])):
        for name in (n for n in ref_state if n not in ref_g["grads"]):
            ref = ref_state[name]
            err = (state[name].cpu() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            buffer_err = max(buffer_err, err)
            if not err <= 1e-3:
                problems.append(f"buffer {name} after {label}: err {err:.3e} of its largest")
    for name in generator:  # the discriminator step leaves the generator alone
        if not torch.equal(after_d["state"][name], after_g["state"][name]):
            problems.append(f"parameter {name} moved in the discriminator step")
    extra_err = 0.0
    for got, ref in zip(after_g["extra"], ref_g["extra"]):
        err = (got.cpu() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        extra_err = max(extra_err, err)
        if not err <= 1e-3:
            problems.append(f"centroids or MI matrix: err {err:.3e} of its largest")
    if problems:
        for problem in problems[:12]:
            print(f"  card vs CPU: {problem}")
        raise SmokeFailure(f"card vs CPU phase-3 step: {len(problems)} checks failed, first: {problems[0]}")
    out = {"loss": metrics["loss"].item(), "ref_loss": ref_metrics["loss"].item(),
           "discriminator_loss": metrics["discriminator_loss"].item(),
           "ref_discriminator_loss": ref_metrics["discriminator_loss"].item(),
           "g_grad_rel_err": g_err, "g_grad_mean_rel_err": g_mean[0], "g_grad_worst_mean": g_mean[1],
           "d_grad_rel_err": d_err, "d_grad_mean_rel_err": d_mean[0], "d_grad_worst_mean": d_mean[1], "g_param_err": param_err, "g_sign_clear_elements": clear,
           "d_param_err": d_param_err, "d_sign_clear_elements": d_clear, "buffer_err": buffer_err,
           "extra_err": extra_err, "grads": len(ref_g["grads"])}
    print(f"phase-3 G+D step card vs CPU (bs 16 x 9 obs, 2 players, F 256): loss {out['loss']:.6f} vs "
          f"{out['ref_loss']:.6f}, discriminator loss {out['discriminator_loss']:.6f} vs "
          f"{out['ref_discriminator_loss']:.6f}; G gradients ({len(ref_g['grads'])} tensors) within {g_err:.3e} of "
          f"their model's largest (mean {g_mean[0]:.3e}, {g_mean[1]}), D gradients within {d_err:.3e} (mean "
          f"{d_mean[0]:.3e}, {d_mean[1]}); "
          f"{clear} + {d_clear} parameter elements with a clear sign within {param_err:.3e} / {d_param_err:.3e} "
          f"after G / D; running statistics and u/sigma within {buffer_err:.3e}, centroids and MI matrices within "
          f"{extra_err:.3e} of their largest")
    return out


def phase10_main_path(steps=PHASE3_STEPS, device="cuda"):
    """The phase-3 main path: bench.py's fused G+D step (bs 16 x 9
    observations, 2 players at the published widths, GAN and ACMV on) for
    `steps` steps on the card, seeded weights and random streams. (On the
    CPU, for a rehearsal, the plain versions run and no launch is counted.)"""
    import torch

    from playableenvironments_tpu_torch.ops import fused_rollout as fr
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cuda = device == "cuda"
    trainer, encoding = phase3_trainer(device, seed=0)
    model = trainer.playable_model
    rng = RngStreams(0, device)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    extra_before = [c.clone() for c in trainer.centroids + trainer.mi_matrices]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fr.fused_rollout_fwd.launches = 0
    fr.fused_rollout_bwd.launches = 0
    step_ms, losses, d_losses = [], [], []
    for _ in range(steps):
        start = time.perf_counter()
        metrics = trainer.fused_step(encoding, rng)
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        losses.append(metrics["loss"].item())
        d_losses.append(metrics["discriminator_loss"].item())
    launches = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if not all(math.isfinite(x) for x in losses + d_losses):
        raise SmokeFailure(f"phase-3 losses {losses}, discriminator losses {d_losses}")
    params = dict(model.named_parameters())
    for name, p in params.items():
        if not bool(torch.isfinite(p).all()):
            raise SmokeFailure(f"parameter {name} is not finite after {steps} steps")
    state = model.state_dict()
    generator_count = sum(not n.startswith("discriminator") for n in params)
    discriminator_count = len(params) - generator_count
    moved_g = sum(not torch.equal(state[n], before[n]) for n in params if not n.startswith("discriminator"))
    moved_d = sum(not torch.equal(state[n], before[n]) for n in params if n.startswith("discriminator"))
    extra_moved = sum(not torch.equal(a, b) for a, b in zip(trainer.centroids + trainer.mi_matrices, extra_before))
    if moved_g < 0.95 * generator_count or moved_d < discriminator_count or extra_moved < len(extra_before):
        raise SmokeFailure(f"{moved_g}/{generator_count} generator and {moved_d}/{discriminator_count} "
                           f"discriminator parameters, {extra_moved}/{len(extra_before)} centroids and MI matrices "
                           "moved")
    if launches != ((4 * steps, 2 * steps) if cuda else (0, 0)):
        raise SmokeFailure(f"B4/B5 launches {launches} in {steps} steps, expected 4 and 2 per step")
    median = statistics.median(step_ms[2:])
    print(f"phase-3 G+D step (bs 16 x 9 obs, 2 players, dynamics 2 x 256, GAN and ACMV): {steps} steps, "
          f"B4 {launches[0]} and B5 {launches[1]} launches; median step {median:.3f} ms over steps 3-{steps}; "
          f"all steps ms {[round(t, 3) for t in step_ms]}; losses {[round(x, 6) for x in losses]}; "
          f"{moved_g}/{generator_count} generator and {moved_d}/{discriminator_count} discriminator parameters, "
          f"{extra_moved}/{len(extra_before)} centroids and MI matrices moved; peak memory {peak / 2**20:.1f} MiB")
    return {"launches": launches, "step_ms": step_ms, "median_step_ms": median, "losses": losses,
            "discriminator_losses": d_losses, "peak_memory_bytes": peak}


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

    # ---- 1. build (one nvcc per source, started together) ------------------
    start = time.perf_counter()
    reports = fused_nerf.build_kernels()
    print(f"build: {', '.join('csrc/' + name for name in reports)} in {time.perf_counter() - start:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip().split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

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

    # ---- 5-7. phase-2 training, 8-10. phase-3 training ------------------------
    try:
        fwd_rows, bwd_rows = phase5_backbone_kernels()
        card_vs_cpu = phase6_card_vs_cpu()
        phase2 = phase7_main_path()
        rollout_rows, rollout_timing = phase8_rollout_kernels()
        phase3_card_vs_cpu = phase9_card_vs_cpu()
        phase3 = phase10_main_path()
    except SmokeFailure as e:
        return fail(str(e))

    # ---- report -----------------------------------------------------------
    def kernel_entry(name, source, replaces, launches, rows):
        total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms", "gflop", "mbytes")}
        ops_bound = total["gflop"] * 1e9 / PEAK_BF16_FLOPS > total["mbytes"] * 1e6 / PEAK_BYTES_PER_S
        return {
            "name": name,
            "route": "cuda",
            "source": f"playableenvironments_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": "operations" if ops_bound else "bytes",
            "library_ms": total["library_ms"],
        }

    kernels = [
        kernel_entry("fused_adain_nerf", "fused_nerf.cu", "playableenvironments_tpu/ops/fused_nerf.py:111",
                     launches, shapes),
        kernel_entry("fused_backbone_fwd", "fused_backbone.cu", "playableenvironments_tpu/ops/fused_nerf.py:375",
                     phase2["launches"][0], fwd_rows),
        kernel_entry("fused_backbone_bwd", "fused_backbone.cu", "playableenvironments_tpu/ops/fused_nerf.py:404",
                     phase2["launches"][1], bwd_rows),
    ]
    # B4/B5 per phase-3 step: two B4 launches that collect residuals (the
    # generator pass) and two that do not (the discriminator pass), two B5.
    # No single PyTorch call computes the rollout (torch.nn.LSTM / cuDNN
    # cannot feed the head's output back as the next step's input), so
    # library_ms is null.
    t = rollout_timing
    kernels += [
        {"name": "fused_rollout_fwd", "route": "cuda", "source": "playableenvironments_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "playableenvironments_tpu/ops/fused_rollout_pallas.py:87", "launches": phase3["launches"][0],
         "max_abs_err": max(r["fwd_max_rel_err"] for r in rollout_rows), "ms": 2 * (t["fwd_res_ms"] + t["fwd_ms"]),
         "plain_ms": 2 * (t["fwd_res_plain_ms"] + t["fwd_plain_ms"]),
         "bound_ms": 2 * (t["fwd_res_bound_ms"] + t["fwd_bound_ms"]), "bound_by": t["fwd_bound_by"],
         "library_ms": None},
        {"name": "fused_rollout_bwd", "route": "cuda", "source": "playableenvironments_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "playableenvironments_tpu/ops/fused_rollout_pallas.py:189", "launches": phase3["launches"][1],
         "max_abs_err": max(r["bwd_max_rel_err"] for r in rollout_rows), "ms": 2 * t["bwd_ms"],
         "plain_ms": 2 * t["bwd_plain_ms"], "bound_ms": 2 * t["bwd_bound_ms"], "bound_by": t["bwd_bound_by"],
         "library_ms": None},
    ]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "shapes": shapes, "step_ms": step_ms, "frame_ms": frame_ms,
                   "backbone_fwd_shapes": fwd_rows, "backbone_bwd_shapes": bwd_rows,
                   "train_card_vs_cpu": card_vs_cpu, "phase2": phase2, "rollout_shapes": rollout_rows,
                   "phase3_card_vs_cpu": phase3_card_vs_cpu, "phase3": phase3, "kernels": kernels,
                   "ptxas": reports}, f, indent=1)
    print(
        "tf32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} (PyTorch defaults; the port sets neither)"
    )
    print("kernel ms/plain_ms/library_ms/bound_ms are sums over the launches of one frame (fused_adain_nerf) or "
          "one train step (the others: the four phase-2 shapes for fused_backbone_fwd/bwd; 2 + 2 B4 and 2 B5 "
          "launches of the phase-3 shape); fused_backbone_fwd/bwd ms are whole wrapper calls as the autograd "
          "Function makes them (the forward's weight-image build included; phase 5 prints the kernels' own "
          "times beside them); max_abs_err of fused_backbone_bwd and fused_rollout_fwd/bwd is "
          "relative to each output's largest magnitude; fused_rollout bounds use the f32 peak "
          f"({PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), the others the bf16 one ({PEAK_BF16_FLOPS / 1e12:.0f})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
