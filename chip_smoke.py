#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: the tennis play loop, the
tennis phase-2 train step, the tennis phase-3 (action module) G+D step, the
data path from a dataset on disk to each of them, the Minecraft family, and
the published training pipeline (phase 2's decoder path for tennis and
Minecraft, phase 1).

    python3 chip_smoke.py

Phases, each fatal on failure:
1. build the port's CUDA kernels (csrc/fused_nerf.cu, csrc/fused_backbone.cu,
   csrc/fused_rollout.cu), one nvcc per source, started together;
2. hold the B1 kernel against its plain PyTorch version for each of the
   tennis frame's four objects alone and for the frame as one grouped
   launch, and time each, the plain version, a library yardstick (the same
   MLP as a chain of bf16 torch.matmul, never called by the port) and the
   bound; print the weight-image bytes a frame from L2, the clusters the
   card places at once and ptxas's registers, shared memory and spills for
   the kernel;
3. check a small frame, its composited NeRF features and the dynamics state
   against the same seeded modules on the CPU;
4. drive the main path: configs/tennis.yaml at full width with seeded random
   weights, an InteractiveSession at 512x288 (strides 4 and 8), scripted
   steps for both players; every frame (288, 512, 3), finite, in [0, 1], and
   one grouped B1 launch covering 4 objects per frame;
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
   per step, the median step time and the peak memory;
11. from video on disk: write a tennis-shaped dataset (2 players, 288x512)
   with the port's Video and load it back through cli/common.py's
   build_dataset; the eval-mode scene encoding of a test batch (bs 4) on the
   card and on the CPU; InteractiveSession.initialize(batch) and 12 steps
   (one grouped B1 launch of 4 objects a frame, the first frame against the
   CPU session's); the reconstructed test split at batch 4 (one B1 launch a
   batch, that launch held against plain_adain_nerf); the phase-3 encoding
   cache of the train split (save, load, fingerprint) and G+D steps over
   its batches and with step_with_batch on dataset batches (4 B4 and 2 B5
   launches a step). It prints the PNG codec it used;
12. the Minecraft family (configs/minecraft.yaml at full width and depth):
   B1 at the Minecraft frame's shapes (the uncompacted background and two
   players of one weight image, 276,480 points in one launch of 3 objects)
   and at the creator's batch of 4, each object against plain_adain_nerf,
   timed with the plain version, the library chain and the bound; a frame
   and its skybox card vs CPU, with the background samples the overlap fix
   masks and the skybox MLP's time; the play loop at 512x288 (one B1
   launch of 3 objects a frame); from a Minecraft dataset on disk, the eval
   encoding with the learned pose encoder (card vs CPU), play from a batch
   and the creator at batch 4; phase 3 over the Minecraft encoding cache
   (bs 16 x 9, the generator step alone: 2 B4 and 2 B5 launches a step) and
   one step card vs CPU;
13. the published training pipeline: B2 against its plain version on every
   row of the phase-2 decoder path's largest launch and B3 at 1,048,613
   points, twice (bit-identical), timed; (a) one decoder-path step of a
   tiny tennis scene (48x64, patch 8, strides 4 and 8) card vs CPU with
   full-precision convolutions on both, the patch centres drawn once on
   the CPU; (b) configs/tennis.yaml's phase 2
   at full width (patch 64 decoded by the v8 VAE, the autoencoder's rate
   group frozen, bench.py's bf16 fused-backbone overrides) at its per-card
   batch for 6 steps: losses finite, the composer moved, the autoencoder
   still and the decoder's running statistics moved, 4 B2 and 4 B3
   launches a step; (c) the same for Minecraft (a tiny step card vs CPU
   with the overlap fix masking samples, then configs/minecraft.yaml's
   phase 2 at full width, 4 steps, 3 + 3 launches a step); (d) one phase-1
   step at the published widths, v8 and v9, f32 and bf16, card vs CPU on
   the same noise (a bf16 step also against the same step in f32); (e)
   bench.py's phase-1 step (bs 20 x 288x512, bf16, VGG19 perceptual 0.1,
   KL 5e-6) for 6 steps. Each path prints its median step and peak memory.
`python3 chip_smoke.py --phase 12` (or `--phase 13`) builds the kernels and
runs that phase alone (no kernels line, no contract line).
Details go to chiprun_out/chip_smoke.json. Prints one JSON line of kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import contextlib
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


def cuda_ms_back_to_back(fn, warmup: int = 3, reps: int = 20) -> float:
    """CUDA-event time of `reps` calls of `fn` enqueued back to back, per
    call: the device's time where the host enqueues faster than the card
    runs, without the wrapper's host time between events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    """A failed check of phases 2-11 (main() reports it and exits 1)."""


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

    def uniform(self, stream, shape):
        self.draws.append(self.streams.uniform(stream, shape))
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

    gumbel = uniform = normal


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


def _compare_parameters(label, state, ref_state, ref_grads, noise, lr, problems, floor=1e-6):
    """Parameters after an Adam step: where the CPU gradient is clear of the
    card-vs-CPU noise (and above `floor`), to 1e-6 + 1e-4 relative;
    everywhere to 2 lr. :return: (max error where the sign is clear, clear
    elements)."""
    worst, count = 0.0, 0
    for name, ref_grad in ref_grads.items():
        ref = ref_state[name]
        diff = (state[name].cpu() - ref).abs()
        clear = ref_grad.abs() > max(2 * noise[name], floor)
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


# ---- phase 11: from video on disk to the card ---------------------------------

# The dataset phase 11 writes (1 camera, 288x512 frames, 2 players on random
# walks from numpy seed 0): videos and frames per split; the camera behind
# the court looking down it; the raw tennis focal, which the frames are
# rendered at times the tennis focal multiplier; each player's (x, y) range.
DATA_SPLITS = {"train": (2, 40), "test": (2, 12)}
DATA_CAMERA = ((1.2, 0.0, 0.0), (0.0, -30.0, 10.0))
DATA_FOCAL = 600.0
DATA_PLAYERS = (((-4.0, 4.0), (-10.0, -2.0)), ((-4.0, 4.0), (2.0, 10.0)))
CREATOR_BATCH = 4
CACHE_BATCH = 32
PHASE11_CACHE_STEPS, PHASE11_BATCH_STEPS = 6, 3
# The eval-mode encoding, card vs CPU (beside phase 6's train-mode step): the
# object encoders' convolutions run in TF32 on the card (~1e-3 relative a
# convolution) through up to 20 convolutions, with running statistics and
# no batch norm to amplify it; styles and deformations are held to 2e-2 of
# each field's largest magnitude element-wise and 2e-3 in the mean. The
# poses come from the boxes and cameras through f32 arithmetic alone: 1e-4
# of their largest magnitude. object_in_scene and the cameras exactly.
CODE_REL_ATOL, CODE_REL_MEAN, POSE_REL_ATOL = 2e-2, 2e-3, 1e-4
# B1 at the creator's batch-4 launch: each object's output equals its launch
# alone bit for bit (the pair table, tile counts and offsets at 4x a frame's
# points), and against plain_adain_nerf it is held to phase 2's bounds
# (KERNEL_ATOL and the rest) in units of the output's mean magnitude where
# that exceeds 1. Those bounds are absolute, set where the outputs are O(1);
# bf16 operand rounding errs in proportion to the activations, which grow
# with the AdaIN modulation. The random encoders give player 1 a modulation
# of up to 8 and outputs of mean magnitude ~3, and then the plain version
# itself moves by 4.4e-2 (mean 8.8e-5) against the same products summed in
# float64, as far as the kernel does (scripts/check_b1_batch.py).


def write_tennis_dataset(root):
    """Phase 11's dataset under `root`, written by the port's Video; returns
    (ms to write a frame, the PNG codec)."""
    from playableenvironments_tpu_torch.data import synthetic, video

    codec = video.png_codec()
    frames = sum(v * f for v, f in DATA_SPLITS.values())
    start = time.perf_counter()
    synthetic.make_two_player_dataset(
        root, height=IMAGE_SIZE[0], width=IMAGE_SIZE[1], focal=DATA_FOCAL,
        focal_length_multiplier=FOCAL_LENGTH_MULTIPLIER, camera_rotation=DATA_CAMERA[0],
        camera_translation=DATA_CAMERA[1], player_ranges=DATA_PLAYERS, seed=0, splits=tuple(DATA_SPLITS),
        frames_by_split=DATA_SPLITS,
    )
    return (time.perf_counter() - start) * 1e3 / frames, codec


def tennis_config(repo, root, section="training", **overrides):
    """configs/tennis.yaml with `data.data_root` at `root` and the batching
    of `section` (`training` or `playable_model_training`), with
    `overrides`, as `training.batching`."""
    from playableenvironments_tpu_torch.cli.common import load_yaml, with_batching_overrides

    cfg = load_yaml(os.path.join(repo, "configs", "tennis.yaml"))
    cfg["data"]["data_root"] = root
    cfg["training"] = {**cfg.get("training", {}), "batching": cfg[section]["batching"]}
    return with_batching_overrides(cfg, **overrides)


def compare_encodings(label, got, ref, learned_rotations=False):
    """Max errors of a card encoding against the CPU's, relative to each
    field's largest magnitude; raises beyond the bounds stated above. With
    `learned_rotations` (the Minecraft players' pose CNN, whose TF32
    convolutions move its yaw as they move the codes) the rotations are held
    to the codes' bounds."""
    import torch

    errors = {}
    for field in ("camera_rotations", "camera_translations", "focals", "object_rotations", "object_translations",
                  "object_style", "object_deformation", "object_in_scene"):
        g, r = getattr(got, field).cpu(), getattr(ref, field)
        if g.shape != r.shape:
            raise SmokeFailure(f"{label} {field}: shape {tuple(g.shape)} vs {tuple(r.shape)}")
        if field in ("camera_rotations", "camera_translations", "focals", "object_in_scene"):
            if not torch.equal(g, r):
                raise SmokeFailure(f"{label} {field} differs between the card and the CPU")
            continue
        if not bool(torch.isfinite(g).all()):
            raise SmokeFailure(f"{label} {field} is not finite")
        scale = max(r.abs().max().item(), 1e-30)
        diff = (g - r).abs()
        errors[field] = (diff.max().item() / scale, diff.mean().item() / scale)
        geometric = field == "object_translations" or (field == "object_rotations" and not learned_rotations)
        atol, mean = (POSE_REL_ATOL, POSE_REL_ATOL) if geometric else (CODE_REL_ATOL, CODE_REL_MEAN)
        if not (errors[field][0] <= atol and errors[field][1] <= mean):
            raise SmokeFailure(f"{label} {field}: card vs CPU err {errors[field][0]:.3e} of its largest magnitude, "
                               f"mean {errors[field][1]:.3e}")
    return errors


def phase3_data_trainer(env_model, device):
    """phase3_trainer's configuration over the frozen `env_model`."""
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train.trainer_playable import (
        PlayableLossWeights, PlayableTrainer, PlayableTrainingConfig,
    )

    model = PlayableEnvironmentModel(phase3_scene(), with_discriminators=True, device=device, seed=0)
    return PlayableTrainer(model, PlayableTrainingConfig(
        ground_truth_observations_start=PHASE3_GT, loss_weights=PlayableLossWeights(gan=0.1, acmv=0.1)),
        environment_model=env_model)


def phase11_from_data(repo, scene, play_median_ms, phase3_median_ms, device="cuda"):
    """The data path on the card: write a tennis-shaped dataset (11a), the
    eval-mode encoding of a test batch card vs CPU (11b), play from a batch
    (11c), the reconstructed test split at batch 4 (11d), phase 3 from the
    encoding cache and from dataset batches (11e)."""
    import tempfile

    import numpy as np
    import torch

    from playableenvironments_tpu_torch.cli.common import build_dataset
    from playableenvironments_tpu_torch.cli.play import InteractiveSession
    from playableenvironments_tpu_torch.data.batching import collate
    from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
    from playableenvironments_tpu_torch.data.video import Video, _save_image
    from playableenvironments_tpu_torch.eval.creators import FrameRenderer, ReconstructedDatasetCreator
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.ops import fused_rollout as fr
    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
    from playableenvironments_tpu_torch.train.encoding_cache import EncodingCache, params_fingerprint
    from playableenvironments_tpu_torch.utils.random import RngStreams

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 11a. the dataset ---------------------------------------------
        root = os.path.join(tmp, "tennis")
        write_ms, codec = write_tennis_dataset(root)
        test = build_dataset(tennis_config(repo, root, observations_count=1, skip_frames=0), "test")
        clip = Video().load(test.videos[0].videos[0].path)
        start = time.perf_counter()
        decoded = [clip.get_frame(i) for i in range(clip.frames_count)]
        read_ms = (time.perf_counter() - start) * 1e3 / clip.frames_count
        start = time.perf_counter()
        for i, frame in enumerate(decoded):
            _save_image(frame, os.path.join(tmp, f"{i:05}.png"))
        png_ms = (time.perf_counter() - start) * 1e3 / len(decoded)
        if len(test) != DATA_SPLITS["test"][0] * DATA_SPLITS["test"][1]:
            raise SmokeFailure(f"the test split loads as {len(test)} frames")
        sample = test[0]
        if sample["observations"].shape != (1, 1) + IMAGE_SIZE + (3,) or sample["bounding_boxes"].shape != (1, 1, 2, 4):
            raise SmokeFailure(f"a test sample has observations {sample['observations'].shape}, boxes "
                               f"{sample['bounding_boxes'].shape}")
        out["data"] = {"codec": codec, "write_ms_a_frame": png_ms, "dataset_ms_a_frame": write_ms,
                       "read_ms_a_frame": read_ms}
        print(f"11a dataset: {DATA_SPLITS} (videos, frames) at {IMAGE_SIZE[1]}x{IMAGE_SIZE[0]}, 2 players; PNG codec "
              f"{codec}; {png_ms:.2f} ms to write a frame's PNG and {read_ms:.2f} ms to decode one ({write_ms:.2f} ms "
              f"a frame to write the dataset, its analytic render included)")

        # ---- 11b. the eval-mode encoding, card vs CPU -----------------------
        batch = next(test.iterate_batches(4, shuffle=False))
        card, host = (InteractiveSession.from_scene(scene, image_size=IMAGE_SIZE, patch_strides=STRIDES,
                                                    focal_length_multiplier=FOCAL_LENGTH_MULTIPLIER, device=dev,
                                                    seed=0) for dev in (device, "cpu"))
        encoding = card.renderer.encode(batch)
        errors = compare_encodings("11b encoding", encoding, host.renderer.encode(batch))
        encode_ms = cuda_ms(lambda: card.renderer.encode(batch)) if device == "cuda" else 0.0
        out["encoding"] = {"errors": errors, "ms": encode_ms}
        print(f"11b eval encoding (bs 4 x 1 obs, {IMAGE_SIZE[1]}x{IMAGE_SIZE[0]}, 4 objects): card vs CPU "
              + ", ".join(f"{k} {v[0]:.3e} (mean {v[1]:.3e})" for k, v in errors.items())
              + f" of each field's largest magnitude; {encode_ms:.3f} ms on the card (median of 20)")

        # ---- 11c. play from a batch ------------------------------------------
        first = next(test.iterate_batches(1, shuffle=False))
        fused_nerf.fused_adain_nerf.launches = 0
        fused_nerf.fused_adain_nerf.objects = 0
        play = [card.initialize(first)]
        step_ms = []
        for i in range(STEPS):
            start = time.perf_counter()
            play.append(card.step(list(ACTIONS[i % len(ACTIONS)])))
            step_ms.append((time.perf_counter() - start) * 1e3)
        launches, objects = fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects
        ref = host.initialize(first)
        frame_err = float(np.abs(play[0] - ref).max())
        for i, frame in enumerate(play):
            if frame.shape != IMAGE_SIZE + (3,) or not np.isfinite(frame).all():
                raise SmokeFailure(f"11c frame {i} has shape {frame.shape} or is not finite")
        if device == "cuda" and (launches, objects) != (len(play), 4 * len(play)):
            raise SmokeFailure(f"11c: {launches} B1 launches covering {objects} objects for {len(play)} frames")
        if not frame_err <= FRAME_ATOL:
            raise SmokeFailure(f"11c: the first frame differs from the CPU session's by {frame_err:.3e}")
        median = statistics.median(step_ms[2:])
        out["play"] = {"launches": launches, "objects": objects, "frame_err": frame_err, "step_ms": step_ms,
                       "median_step_ms": median}
        print(f"11c play from a batch: initialize + {STEPS} steps at {IMAGE_SIZE[1]}x{IMAGE_SIZE[0]}, {launches} grouped "
              f"B1 launches "
              f"covering {objects} objects; first frame card vs CPU max abs err {frame_err:.3e} (tolerance "
              f"{FRAME_ATOL}); median step {median:.3f} ms vs {play_median_ms:.3f} ms from an encoding (phase 4)")

        # ---- 11d. the reconstructed test split --------------------------------
        grouped = fused_nerf.fused_adain_nerf_group
        captured = []

        def capture(cfg, items):
            outs = grouped(cfg, items)
            if not captured:
                captured.append((cfg, items, outs))
            return outs

        mirror = os.path.join(tmp, "mirror")
        creator = ReconstructedDatasetCreator(FrameRenderer(card.renderer.model, card.autoencoder, IMAGE_SIZE,
                                                            STRIDES), batch_size=CREATOR_BATCH)
        fused_nerf.fused_adain_nerf_group = capture
        fused_nerf.fused_adain_nerf.launches = 0
        fused_nerf.fused_adain_nerf.objects = 0
        try:
            if device == "cuda":
                torch.cuda.synchronize()
            start = time.perf_counter()
            creator.reconstruct_dataset(test, mirror)
            if device == "cuda":
                torch.cuda.synchronize()
            creator_s = time.perf_counter() - start
        finally:
            fused_nerf.fused_adain_nerf_group = grouped
        launches, objects = fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects
        total = len(test)
        batches = -(-total // CREATOR_BATCH)
        pngs = sum(f.endswith(".png") for _, _, files in os.walk(mirror) for f in files)
        reloaded = MulticameraVideoDataset(mirror, observations_count=1)
        if pngs != total or len(reloaded) != total:
            raise SmokeFailure(f"11d: {pngs} PNGs, a mirror of {len(reloaded)} frames, for {total} frames")
        if device == "cuda" and (launches, objects) != (batches, 4 * batches):
            raise SmokeFailure(f"11d: {launches} B1 launches covering {objects} objects for {batches} batches")
        cfg, items, outs = captured[0]
        rows, scales = [], []
        with torch.no_grad():
            for index, (item, (feats, alpha)) in enumerate(zip(items, outs)):
                args = (item.encoded, item.scale0, item.bias0, item.scale1, item.bias1)
                alone = fused_nerf.fused_adain_nerf(cfg, item.weights, *args, samples_per_ray=item.samples_per_ray)
                if not all(torch.equal(a, b) for a, b in zip(alone, (feats, alpha))):
                    raise SmokeFailure(f"11d: object {index} of the batch-{CREATOR_BATCH} B1 launch differs from "
                                       "the same object launched alone")
                refs = fused_nerf.plain_adain_nerf(cfg, item.weights.packed, *args, item.samples_per_ray)
                pair = []
                for name, got, ref in (("features", feats, refs[0]), ("alpha", alpha, refs[1])):
                    scale = max(1.0, ref.abs().mean().item())
                    scales.append(scale)
                    err = check_close(f"11d B1 batch-{CREATOR_BATCH} object {index} {name} (over {scale:.3f})",
                                      got / scale, ref / scale, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
                    pair.append((err[0] * scale, err[1] * scale))
                rows.append(pair)
            b1_ms = cuda_ms(lambda: grouped(cfg, items)) if device == "cuda" else 0.0
            b1_back_ms = cuda_ms_back_to_back(lambda: grouped(cfg, items)) if device == "cuda" else 0.0
        work = [mlp_work(cfg, item.weights.packed, item.encoded.shape[0], item.scale0.shape[0]) for item in items]
        flops, bytes_ = sum(w[0] for w in work), sum(w[1] for w in work)
        b1_bound = max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES_PER_S) * 1e3
        points = sum(item.encoded.shape[0] for item in items)
        out["creator"] = {
            "frames": total, "batches": batches, "launches": launches, "objects": objects, "seconds": creator_s,
            "frames_per_s": total / creator_s, "ms_a_batch": creator_s * 1e3 / batches, "b1_points": points,
            "b1_ms": b1_ms, "b1_back_to_back_ms": b1_back_ms, "b1_bound_ms": b1_bound,
            "b1_bound_by": "operations" if flops / PEAK_BF16_FLOPS > bytes_ / PEAK_BYTES_PER_S else "bytes",
            "b1_max_abs_err": max(r[0] for pair in rows for r in pair),
            "b1_mean_abs_err": max(r[1] for pair in rows for r in pair), "b1_output_scales": scales,
        }
        print(f"11d reconstructed test split: {total} frames in {batches} batches of {CREATOR_BATCH}, {launches} B1 "
              f"launches covering {objects} objects, {pngs} PNGs, the mirror loads; {total / creator_s:.2f} frames/s, "
              f"{creator_s * 1e3 / batches:.1f} ms a batch; the batch-{CREATOR_BATCH} B1 launch ({points} points): "
              f"each object bit-identical to its launch alone, max abs err {out['creator']['b1_max_abs_err']:.3e}, "
              f"mean {out['creator']['b1_mean_abs_err']:.3e} against plain (output scales "
              f"{[round(x, 3) for x in scales]}); {b1_ms:.4f} ms ({b1_back_ms:.4f} ms back to back) against a {b1_bound:.4f} ms bound")
        del captured, items, outs, card, host

        # ---- 11e. phase 3 from the encoding cache and from batches -----------
        train = build_dataset(tennis_config(repo, root, "playable_model_training"), "train")
        env_model = EnvironmentModel(phase3_scene(), FOCAL_LENGTH_MULTIPLIER, device=device, seed=0)
        trainer = phase3_data_trainer(env_model, device)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        cache = EncodingCache.build(trainer.encode_batch, train, batch_size=CACHE_BATCH)
        cache_s = time.perf_counter() - start
        cached_frames = cache.encoding.object_style.shape[0]
        fingerprint = params_fingerprint(env_model)
        path = os.path.join(tmp, "encoding_cache.npz")
        cache.save(path, fingerprint=fingerprint)
        loaded = EncodingCache.load(path, fingerprint=fingerprint)
        for field, leaf in vars(cache.encoding).items():
            if not np.array_equal(getattr(loaded.encoding, field), leaf):
                raise SmokeFailure(f"11e: the cache's {field} changed through save and load")
        try:
            EncodingCache.load(path, fingerprint=fingerprint * 1.001)
            raise SmokeFailure("11e: a stale fingerprint loaded")
        except ValueError:
            pass
        T = train.observations_count

        def cache_batches():
            for epoch in range(PHASE11_CACHE_STEPS):
                yield from loaded.iterate_encoding_batches(PHASE3_BATCH, T, seed=epoch, device=device)

        batches = cache_batches()
        trainer.init_state_from_encoding(next(batches), seed=0)
        rng = RngStreams(0, device)
        fr.fused_rollout_fwd.launches = 0
        fr.fused_rollout_bwd.launches = 0
        cache_ms, gather_ms, losses = [], [], []
        for _ in range(PHASE11_CACHE_STEPS):
            start = time.perf_counter()
            encoding = next(batches)
            gather_ms.append((time.perf_counter() - start) * 1e3)
            start = time.perf_counter()
            metrics = trainer.fused_step(encoding, rng)
            if device == "cuda":
                torch.cuda.synchronize()
            cache_ms.append((time.perf_counter() - start) * 1e3)
            losses.append(metrics["loss"].item())
        cache_launches = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
        def dataset_batches():
            for epoch in range(PHASE11_BATCH_STEPS):
                yield from train.iterate_batches(PHASE3_BATCH, seed=epoch)

        # Steps while the prefetch thread decodes the next batch on the host,
        # as a training loop runs them, then the same number on batches
        # decoded beforehand.
        batch_iter = dataset_batches()
        fr.fused_rollout_fwd.launches = 0
        fr.fused_rollout_bwd.launches = 0
        batch_ms, load_ms = [], []
        for _ in range(PHASE11_BATCH_STEPS):
            start = time.perf_counter()
            batch = next(batch_iter)
            load_ms.append((time.perf_counter() - start) * 1e3)
            start = time.perf_counter()
            metrics = trainer.step_with_batch(batch, rng)
            if device == "cuda":
                torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - start) * 1e3)
            losses.append(metrics["loss"].item())
        batch_iter.close()
        batch_launches = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
        preloaded = [collate([train[(b * PHASE3_BATCH + i) % len(train)] for i in range(PHASE3_BATCH)])
                     for b in range(PHASE11_BATCH_STEPS)]
        quiet_ms = []
        for batch in preloaded:
            start = time.perf_counter()
            metrics = trainer.step_with_batch(batch, rng)
            if device == "cuda":
                torch.cuda.synchronize()
            quiet_ms.append((time.perf_counter() - start) * 1e3)
            losses.append(metrics["loss"].item())
        del preloaded
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if not all(math.isfinite(x) for x in losses):
            raise SmokeFailure(f"11e losses {losses}")
        if device == "cuda" and (cache_launches != (4 * PHASE11_CACHE_STEPS, 2 * PHASE11_CACHE_STEPS)
                                 or batch_launches != (4 * PHASE11_BATCH_STEPS, 2 * PHASE11_BATCH_STEPS)):
            raise SmokeFailure(f"11e: B4/B5 launches {cache_launches} in {PHASE11_CACHE_STEPS} cache steps, "
                               f"{batch_launches} in {PHASE11_BATCH_STEPS} batch steps; expected 4 and 2 a step")
        cache_median = statistics.median(cache_ms[2:])
        batch_median = statistics.median(batch_ms[1:])
        quiet_median = statistics.median(quiet_ms)
        out["phase3"] = {
            "cache_frames": cached_frames, "cache_s": cache_s, "cache_frames_per_s": cached_frames / cache_s,
            "cache_launches": cache_launches, "cache_step_ms": cache_ms, "cache_median_step_ms": cache_median,
            "gather_ms": gather_ms, "batch_launches": batch_launches, "batch_step_ms": batch_ms,
            "batch_median_step_ms": batch_median, "batch_load_ms": load_ms, "preloaded_step_ms": quiet_ms,
            "preloaded_median_step_ms": quiet_median, "losses": losses,
            "peak_memory_bytes": peak, "fingerprint": fingerprint,
        }
        print(f"11e phase 3 from data: cache of {cached_frames} frames built in {cache_s:.2f} s "
              f"({cached_frames / cache_s:.1f} frames/s, batches of {CACHE_BATCH}), saved and loaded (fingerprint "
              f"{fingerprint:.6e}, a stale one refused); {PHASE11_CACHE_STEPS} G+D steps over cache batches "
              f"(bs {PHASE3_BATCH} x {T}): B4 {cache_launches[0]}, B5 {cache_launches[1]} launches, median step "
              f"{cache_median:.3f} ms (gather + copy {statistics.median(gather_ms):.3f} ms) vs {phase3_median_ms:.3f} "
              f"ms over a fixed encoding (phase 10); {PHASE11_BATCH_STEPS} step_with_batch steps on dataset batches "
              f"(bs {PHASE3_BATCH} x {T} at {IMAGE_SIZE[1]}x{IMAGE_SIZE[0]}): B4 {batch_launches[0]}, B5 {batch_launches[1]} launches, "
              f"median step {batch_median:.3f} ms beside the prefetch thread's decode of the next batch "
              f"({quiet_median:.3f} ms on batches decoded beforehand; waiting for a batch "
              f"{statistics.median(load_ms):.1f} ms apart); "
              f"peak memory {peak / 2**20:.1f} MiB")
    return out


# ---- phase 12: the Minecraft family ------------------------------------------

# configs/minecraft.yaml's frame at 512x288 (strides 4 and 8: 11,520 rays):
# B1's items per frame, (object, rays, samples): the uncompacted background
# and the two players of one object model, compacted to 1/8 of the rays.
MINECRAFT_LAUNCHES = (("background", 11520, 16), ("player_1", 1440, 32), ("player_2", 1440, 32))
MINECRAFT_FOCAL = 512.0  # the focal stored with the 512-wide frames; minecraft.yaml renders at 0.5 of it
MINECRAFT_MULTIPLIER = 0.5  # configs/minecraft.yaml data.focal_length_multiplier
MINECRAFT_ACTIONS = [(1, 2), (3, 4), (0, 6), (5, 1), (2, 2), (6, 0)]
PHASE12_CACHE_STEPS = 20
# The skybox's features on the card against the CPU's: plain f32 products
# (cuBLAS with TF32 off, PyTorch's default for matmul), ~1e-6 relative a
# product through 11 layers; held to 1e-3 of the largest magnitude.
SKYBOX_REL_ATOL = 1e-3


def minecraft_config(repo, root=None, section="training", **overrides):
    """configs/minecraft.yaml, with `data.data_root` at `root` and the
    batching of `section` as `training.batching`, with `overrides`."""
    from playableenvironments_tpu_torch.cli.common import load_yaml, with_batching_overrides

    cfg = load_yaml(os.path.join(repo, "configs", "minecraft.yaml"))
    if root is not None:
        cfg["data"]["data_root"] = root
    cfg["training"] = {**cfg.get("training", {}), "batching": cfg[section]["batching"]}
    return with_batching_overrides(cfg, **overrides)


def minecraft_encoding(torch, device):
    """A Minecraft frame-0 state: data.synthetic's Minecraft camera (yawed,
    pitched down at 3.5 m), both players on the ground inside the
    background's slab, turned about y."""
    from playableenvironments_tpu_torch.data.synthetic import MINECRAFT_GEOMETRY
    from playableenvironments_tpu_torch.scene.encoding import SceneEncoding

    n = 4
    translations = torch.zeros(1, 1, n, 3)
    translations[0, 0, 2] = torch.tensor([-1.0, 0.0, -1.0])
    translations[0, 0, 3] = torch.tensor([1.5, 0.0, -0.5])
    rotations = torch.zeros(1, 1, n, 3)
    rotations[0, 0, 2:, 1] = torch.tensor([0.4, -0.7])
    generator = torch.Generator().manual_seed(12)
    return SceneEncoding(
        camera_rotations=torch.tensor([[[MINECRAFT_GEOMETRY["camera_rotation"]]]], dtype=torch.float32),
        camera_translations=torch.tensor([[[MINECRAFT_GEOMETRY["camera_translation"]]]], dtype=torch.float32),
        focals=torch.full((1, 1, 1), MINECRAFT_FOCAL),
        object_rotations=rotations,
        object_translations=translations,
        object_style=torch.randn(1, 1, n, 32, generator=generator) * 0.3,
        object_deformation=torch.randn(1, 1, n, 32, generator=generator) * 0.3,
        object_in_scene=torch.ones(1, 1, n, dtype=torch.bool),
    ).map(lambda x: x.to(device))


def masked_background_samples(scene, args):
    """How many samples of the background (object 0) the overlap fix masks
    among render_rays_fast's inputs `args`."""
    from playableenvironments_tpu_torch.config import ObjectIds
    from playableenvironments_tpu_torch.core import compositing
    from playableenvironments_tpu_torch.render import fast

    origins, directions, normals, w2o, _, _, in_scene = args
    ids = ObjectIds(scene)
    lead = tuple(directions.shape[:-2])
    objects = ids.objects_count

    def flat(x, tail):
        return x.expand(lead + tail).reshape((-1,) + tail)

    o, n = flat(origins, (3,)), flat(normals, (3,))
    d = directions.reshape((-1,) + tuple(directions.shape[-2:]))
    w2o, in_scene = flat(w2o, (objects, 4, 4)), flat(in_scene, (objects,))
    t = [fast.object_samples(scene.object_models[ids.model_idx_by_object_idx(i)], o, d, n, w2o[:, i],
                             in_scene[:, i])[3] for i in range(objects)]
    mask = sum(compositing.overlap_fix_mask(t[0], t[i]).int() for i in range(ids.static_objects_count, objects))
    return int((mask > 0).sum())


def minecraft_b1_items(cfg, frames, device, seed=12):
    """B1's items of `frames` Minecraft frames at 512x288 in one launch, as
    render_rays_fast groups them (each object's points over all frames):
    the background with its own seeded weights, both players with one
    model's weights (one image). Returns (items, per item: bf16 weights)."""
    import torch

    from playableenvironments_tpu_torch.models.encoding import positional_encoding
    from playableenvironments_tpu_torch.models.layers import initialize_
    from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
    from playableenvironments_tpu_torch.ops import fused_nerf

    generator = torch.Generator().manual_seed(seed)
    background = initialize_(AdaInNerfMLP(cfg, 32, device=device), generator)
    player = initialize_(AdaInNerfMLP(cfg, 32, device=device), generator)
    items = []
    for (name, rays, samples), nerf in zip(MINECRAFT_LAUNCHES, (background, player, player)):
        rays *= frames
        positions = torch.rand(rays * samples, 3, generator=generator) * 2.0 - 1.0
        encoded = positional_encoding(positions, cfg.position_encoder.octaves, True).to(device, torch.bfloat16)
        style = (torch.randn(rays, 32, generator=generator) * 0.3).to(device)
        with torch.no_grad():
            mods = [*fused_nerf.fold_adain_stats(nerf.adain_0, style), *fused_nerf.fold_adain_stats(nerf.adain_1, style)]
        items.append(fused_nerf.AdaInNerfItem(nerf.kernel_weights(), encoded, *mods, samples))
    return items


def minecraft_b1_launch(cfg, items, label, device="cuda"):
    """One grouped launch of `items` held object by object against
    plain_adain_nerf (phase 11's bounds in units of the output's mean
    magnitude where above 1); its time as called and back to back, the plain
    version's and the bf16 library chain's (both summed over the items) and
    the bound (each input read once: the players' shared weights once)."""
    import torch

    from playableenvironments_tpu_torch.ops import fused_nerf

    with torch.no_grad():
        launches, objects = fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects
        outs = fused_nerf.fused_adain_nerf_group(cfg, items)
        if device == "cuda":
            torch.cuda.synchronize()
        counted = (fused_nerf.fused_adain_nerf.launches - launches, fused_nerf.fused_adain_nerf.objects - objects)
        if device == "cuda" and counted != (1, len(items)):
            raise SmokeFailure(f"{label}: {counted[0]} B1 launches covering {counted[1]} objects, expected 1 of "
                               f"{len(items)}")
        errs, scales = [], []
        for index, (item, (feats, alpha)) in enumerate(zip(items, outs)):
            args = (item.encoded, item.scale0, item.bias0, item.scale1, item.bias1)
            ref = fused_nerf.plain_adain_nerf(cfg, item.weights.packed, *args, item.samples_per_ray)
            for name, got, r in (("features", feats, ref[0]), ("alpha", alpha, ref[1])):
                scale = max(1.0, r.abs().mean().item())
                scales.append(scale)
                err = check_close(f"{label} object {index} {name} (over {scale:.3f})", got / scale, r / scale,
                                  KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
                errs.append((err[0] * scale, err[1] * scale))
        del outs, ref
        timed = device == "cuda"
        group_ms = cuda_ms(lambda: fused_nerf.fused_adain_nerf_group(cfg, items)) if timed else 0.0
        back_ms = cuda_ms_back_to_back(lambda: fused_nerf.fused_adain_nerf_group(cfg, items)) if timed else 0.0

        def plain():
            for it in items:
                fused_nerf.plain_adain_nerf(cfg, it.weights.packed, it.encoded, it.scale0, it.bias0, it.scale1,
                                            it.bias1, it.samples_per_ray)

        bf16 = {}
        for it in items:
            bf16.setdefault(id(it.weights), {k: v.to(torch.bfloat16) for k, v in it.weights.packed.items()})

        def library():
            for it in items:
                library_mlp(cfg, bf16[id(it.weights)], it.encoded, it.scale0, it.bias0, it.scale1, it.bias1,
                            it.samples_per_ray)

        plain_ms = cuda_ms(plain, warmup=1, reps=5) if timed else 0.0
        library_ms = cuda_ms(library) if timed else 0.0
    flops = bytes_ = 0.0
    seen = set()
    for it in items:
        points = it.encoded.shape[0]
        f, b = mlp_work(cfg, it.weights.packed, points, it.scale0.shape[0])
        if id(it.weights) in seen:  # a shared weight image is read once
            _, b0 = mlp_work(cfg, it.weights.packed, 0, 0)
            b -= b0
        seen.add(id(it.weights))
        flops, bytes_ = flops + f, bytes_ + b
    bound = max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES_PER_S) * 1e3
    return {
        "points": sum(it.encoded.shape[0] for it in items), "objects": len(items),
        "weight_images": len(seen),
        "max_abs_err": max(e[0] for e in errs), "mean_abs_err": max(e[1] for e in errs), "output_scales": scales,
        "ms": group_ms, "back_to_back_ms": back_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound, "bound_by": "operations" if flops / PEAK_BF16_FLOPS > bytes_ / PEAK_BYTES_PER_S else "bytes",
        "gflop": flops / 1e9, "mbytes": bytes_ / 1e6,
    }


def minecraft_phase3_step(trainer, encoding, rng):
    """(metrics, gradients, state, centroids + MI matrices) after one
    fused_step (the generator step alone: minecraft.yaml sets no GAN
    weight, so the model has no discriminators)."""
    metrics = trainer.fused_step(encoding, rng)
    model = trainer.playable_model
    return (metrics, {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            [c.clone() for c in trainer.centroids + trainer.mi_matrices])


def phase12_minecraft(repo, device="cuda"):
    """The Minecraft family (configs/minecraft.yaml at full width and depth,
    seeded random weights): B1 at the Minecraft frame's shapes and the
    creator's batch of 4 (12a); a frame and its skybox, card vs CPU (12b);
    the play loop at 512x288 (12c); from a Minecraft dataset on disk: the
    eval encoding with the learned pose encoder, play from a batch and the
    creator at batch 4 (12d); phase 3 over the Minecraft encoding cache and
    one step card vs CPU (12e)."""
    import tempfile

    import numpy as np
    import torch

    from playableenvironments_tpu_torch.cli.common import build_dataset, playable_training_config
    from playableenvironments_tpu_torch.cli.play import InteractiveSession
    from playableenvironments_tpu_torch.config import scene_from_yaml
    from playableenvironments_tpu_torch.data import synthetic
    from playableenvironments_tpu_torch.eval.creators import FrameRenderer, ReconstructedDatasetCreator
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.ops import fused_rollout as fr
    from playableenvironments_tpu_torch.core.rays import transform_rays
    from playableenvironments_tpu_torch.render.fast import frame_rays, render_rays_fast
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train.encoding_cache import EncodingCache
    from playableenvironments_tpu_torch.train.trainer_playable import PlayableTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cuda = device == "cuda"
    scene = scene_from_yaml(os.path.join(repo, "configs", "minecraft.yaml"))
    cfg = scene.object_models[0].nerf
    if scene.object_models[2].nerf != cfg:
        raise SmokeFailure("the Minecraft background and players no longer share a NeRF configuration")
    out = {}

    # ---- 12a. B1 at the Minecraft frame's shapes, and the creator's batch of 4
    phase_start = time.perf_counter()
    frame = minecraft_b1_launch(cfg, minecraft_b1_items(cfg, 1, device), "12a B1 Minecraft frame", device)
    batch4 = minecraft_b1_launch(cfg, minecraft_b1_items(cfg, 4, device), "12a B1 Minecraft batch of 4", device)
    out["b1"] = {"frame": frame, "batch4": batch4, "seconds": time.perf_counter() - phase_start}
    for label, row in (("frame", frame), (f"creator batch of 4", batch4)):
        print(f"12a B1 Minecraft {label} (background {MINECRAFT_LAUNCHES[0][1]} rays x 16, two players of one weight "
              f"image {MINECRAFT_LAUNCHES[1][1]} rays x 32 each, per frame; {row['points']} points in one launch of "
              f"{row['objects']} objects): max abs err {row['max_abs_err']:.3e}, mean {row['mean_abs_err']:.3e} "
              f"against plain (output scales {[round(x, 3) for x in row['output_scales']]}); {row['ms']:.4f} ms as "
              f"called, {row['back_to_back_ms']:.4f} ms back to back; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {100 * row['bound_ms'] / max(row['ms'], 1e-9):.1f}% of it); bf16 torch.matmul "
              f"chain {row['library_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms")

    # ---- 12b. a Minecraft frame on the card against the CPU -------------------
    phase_start = time.perf_counter()
    small = dict(image_size=(48, 64), patch_strides=STRIDES, focal_length_multiplier=MINECRAFT_MULTIPLIER * 64 / 512)
    card = InteractiveSession.from_scene(scene, device=device, seed=0, **small)
    host = InteractiveSession.from_scene(scene, device="cpu", seed=0, **small)
    encoding = minecraft_encoding(torch, "cpu")
    got, ref = card.start(encoding), host.start(encoding)
    frame_err = float(np.abs(got - ref).max())
    if not frame_err <= FRAME_ATOL:
        raise SmokeFailure(f"12b: the Minecraft frame differs from the CPU's by {frame_err:.3e}")
    args = [frame_rays(s.encoding, **small) for s in (card, host)]
    integrals = [render_rays_fast(scene, s.composer, *a)["coarse"] for s, a in zip((card, host), args)]
    errors = {}
    for part, fields, (atol, mean) in (("global", ("integrated_features", "opacity", "depth"), (2e-2, 1e-3)),
                                       ("object_1", ("integrated_features",), (SKYBOX_REL_ATOL, SKYBOX_REL_ATOL))):
        for field in fields:
            g, r = integrals[0][part][field].cpu(), integrals[1][part][field]
            diff = (g - r).abs()
            scale = r.abs().max().item()
            errors[f"{part}.{field}"] = (diff.max().item() / max(scale, 1e-30), diff.mean().item() / max(scale, 1e-30))
            if not (scale > 0 and diff.max().item() <= atol * scale and diff.mean().item() <= mean * scale):
                raise SmokeFailure(f"12b {part} {field}: card vs CPU err up to {diff.max().item():.3e}, mean "
                                   f"{diff.mean().item():.3e}, scale {scale:.3e}")
    if not integrals[1]["object_1"]["opacity"].min().item() > 0.5:
        raise SmokeFailure("12b: the skybox does not cover the frame")
    masked_small = masked_background_samples(scene, args[1])
    del card, host, integrals
    # The skybox MLP and the masked samples at the play frame's 11,520 rays.
    session = InteractiveSession.from_scene(scene, image_size=IMAGE_SIZE, patch_strides=STRIDES,
                                            focal_length_multiplier=MINECRAFT_MULTIPLIER, device=device, seed=0)
    play_args = frame_rays(minecraft_encoding(torch, device), IMAGE_SIZE, STRIDES, MINECRAFT_MULTIPLIER)
    masked = masked_background_samples(scene, play_args)
    sky = session.composer.object_model(1)
    rays = play_args[1].reshape(-1, 3)
    with torch.no_grad():
        # The skybox's rays in its frame, as render_rays_fast hands them over.
        sky_origins, sky_dirs, _ = transform_rays(play_args[0].reshape(-1, 3), rays[None], play_args[2].reshape(-1, 3),
                                                  play_args[3].reshape(-1, 4, 4, 4)[:, 1])
        sky_style = play_args[4].reshape(-1, 4, 32)[:, 1][:, None]
        sky_origins = sky_origins[:, None].expand_as(sky_dirs)
        sky_ms = cuda_ms(lambda: sky.nerf(sky_origins, sky_dirs, scene.object_models[1].bounding_box, sky_style,
                                          None, True)) if cuda else 0.0
    out["frame"] = {"frame_err": frame_err, "errors": errors, "masked_samples_48x64": masked_small,
                    "masked_samples_512x288": masked, "background_samples_512x288": 11520 * 16,
                    "skybox_ms": sky_ms, "seconds": time.perf_counter() - phase_start}
    print(f"12b Minecraft frame 48x64 card vs CPU: frame max abs err {frame_err:.3e} (tolerance {FRAME_ATOL}); "
          + ", ".join(f"{k} {v[0]:.3e} (mean {v[1]:.3e})" for k, v in errors.items())
          + f" of the largest magnitude (skybox features to {SKYBOX_REL_ATOL}); the overlap fix masks {masked_small} "
          f"background samples at 48x64 and {masked} of {11520 * 16} at 512x288; the skybox MLP over 11,520 rays "
          f"{sky_ms:.4f} ms")

    # ---- 12c. the Minecraft play loop at 512x288 ------------------------------
    phase_start = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fused_nerf.fused_adain_nerf.launches = 0
    fused_nerf.fused_adain_nerf.objects = 0
    frames = [session.start(minecraft_encoding(torch, device))]
    step_ms = []
    for i in range(STEPS):
        start = time.perf_counter()
        frames.append(session.step(list(MINECRAFT_ACTIONS[i % len(MINECRAFT_ACTIONS)])))
        step_ms.append((time.perf_counter() - start) * 1e3)
    launches, objects = fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for i, f in enumerate(frames):
        if f.shape != IMAGE_SIZE + (3,) or not np.isfinite(f).all() or f.min() < 0.0 or f.max() > 1.0:
            raise SmokeFailure(f"12c frame {i} has shape {f.shape} or leaves [0, 1]")
    if cuda and (launches, objects) != (len(frames), 3 * len(frames)):
        raise SmokeFailure(f"12c: {launches} B1 launches covering {objects} objects for {len(frames)} frames, "
                           "expected one of 3 a frame")
    moved = [float(np.abs(session.encoding.object_translations[0, 0, i].cpu().numpy()
                          - minecraft_encoding(torch, "cpu").object_translations[0, 0, i].numpy()).max())
             for i in (2, 3)]
    median = statistics.median(step_ms[2:])
    out["play"] = {"launches": launches, "objects": objects, "step_ms": step_ms, "median_step_ms": median,
                   "peak_memory_bytes": peak, "players_moved": moved, "seconds": time.perf_counter() - phase_start}
    print(f"12c Minecraft play loop 512x288: {len(frames)} frames, {launches} grouped B1 launches covering {objects} "
          f"objects; median step {median:.3f} ms ({1e3 / median:.2f} fps) over steps 3-{STEPS}; all steps ms "
          f"{[round(t, 3) for t in step_ms]}; players moved {[round(m, 3) for m in moved]}; peak memory "
          f"{peak / 2**20:.1f} MiB")
    del session, frames

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 12d. from a Minecraft dataset on disk ----------------------------
        phase_start = time.perf_counter()
        root = os.path.join(tmp, "minecraft")
        synthetic.make_two_player_dataset(
            root, height=IMAGE_SIZE[0], width=IMAGE_SIZE[1], focal=MINECRAFT_FOCAL, seed=0,
            splits=tuple(DATA_SPLITS), frames_by_split=DATA_SPLITS, **synthetic.MINECRAFT_GEOMETRY,
        )
        test = build_dataset(minecraft_config(repo, root, observations_count=1, skip_frames=0), "test")
        batch = next(test.iterate_batches(4, shuffle=False))
        card, host = (InteractiveSession.from_scene(scene, image_size=IMAGE_SIZE, patch_strides=STRIDES,
                                                    focal_length_multiplier=MINECRAFT_MULTIPLIER, device=dev, seed=0)
                      for dev in (device, "cpu"))
        encoding = card.renderer.encode(batch)
        errors = compare_encodings("12d Minecraft encoding", encoding, host.renderer.encode(batch),
                                   learned_rotations=True)
        yaw = encoding.object_rotations[..., 2:, 1]
        if not bool((yaw != 0).all()) or bool((encoding.object_rotations[..., 2:, 0::2] != 0).any()):
            raise SmokeFailure("12d: the learned pose encoder's rotations are not about y alone")
        encode_ms = cuda_ms(lambda: card.renderer.encode(batch)) if cuda else 0.0
        first = next(test.iterate_batches(1, shuffle=False))
        fused_nerf.fused_adain_nerf.launches = 0
        fused_nerf.fused_adain_nerf.objects = 0
        play = [card.initialize(first)]
        play_ms = []
        for i in range(STEPS):
            start = time.perf_counter()
            play.append(card.step(list(MINECRAFT_ACTIONS[i % len(MINECRAFT_ACTIONS)])))
            play_ms.append((time.perf_counter() - start) * 1e3)
        launches, objects = fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects
        for i, f in enumerate(play):
            if f.shape != IMAGE_SIZE + (3,) or not np.isfinite(f).all():
                raise SmokeFailure(f"12d play frame {i} has shape {f.shape} or is not finite")
        if cuda and (launches, objects) != (len(play), 3 * len(play)):
            raise SmokeFailure(f"12d play: {launches} B1 launches covering {objects} objects for {len(play)} frames")
        mirror = os.path.join(tmp, "mirror")
        creator = ReconstructedDatasetCreator(FrameRenderer(card.renderer.model, card.autoencoder, IMAGE_SIZE,
                                                            STRIDES), batch_size=CREATOR_BATCH)
        fused_nerf.fused_adain_nerf.launches = 0
        fused_nerf.fused_adain_nerf.objects = 0
        if cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        creator.reconstruct_dataset(test, mirror)
        if cuda:
            torch.cuda.synchronize()
        creator_s = time.perf_counter() - start
        creator_launches = (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects)
        total = len(test)
        batches = -(-total // CREATOR_BATCH)
        pngs = sum(f.endswith(".png") for _, _, files in os.walk(mirror) for f in files)
        if pngs != total:
            raise SmokeFailure(f"12d creator: {pngs} PNGs for {total} frames")
        if cuda and creator_launches != (batches, 3 * batches):
            raise SmokeFailure(f"12d creator: B1 launches and objects {creator_launches} for {batches} batches")
        play_median = statistics.median(play_ms[2:])
        out["data"] = {"encoding_errors": errors, "encode_ms": encode_ms, "play_launches": launches,
                       "play_objects": objects, "play_step_ms": play_ms, "play_median_step_ms": play_median,
                       "creator_frames": total, "creator_seconds": creator_s, "creator_frames_per_s": total / creator_s,
                       "creator_launches": creator_launches, "seconds": time.perf_counter() - phase_start}
        print(f"12d Minecraft data path ({DATA_SPLITS} (videos, frames) at {IMAGE_SIZE[1]}x{IMAGE_SIZE[0]}, "
              f"data.synthetic's Minecraft geometry): eval encoding of bs 4 x 1 with the learned pose encoder "
              f"{encode_ms:.3f} ms (median of 20), card vs CPU "
              + ", ".join(f"{k} {v[0]:.3e} (mean {v[1]:.3e})" for k, v in errors.items())
              + f" of each field's largest magnitude; play from a batch: {launches} B1 launches covering {objects} "
              f"objects, median step {play_median:.3f} ms; the creator over {total} test frames at batch "
              f"{CREATOR_BATCH}: {total / creator_s:.2f} frames/s, {creator_launches[0]} B1 launches covering "
              f"{creator_launches[1]} objects")
        env_model = card.renderer.model
        del card, host, creator

        # ---- 12e. phase 3 over the Minecraft encoding cache -------------------
        phase_start = time.perf_counter()
        cfg_yaml = minecraft_config(repo, root, "playable_model_training")
        train = build_dataset(cfg_yaml, "train")
        T = train.observations_count
        bs = int(cfg_yaml["playable_model_training"]["batching"]["batch_size"])
        train_cfg = playable_training_config(cfg_yaml)
        if train_cfg.loss_weights.gan != 0.0:
            raise SmokeFailure("minecraft.yaml's phase 3 sets a GAN weight; phase 12e expects none")
        trainer = PlayableTrainer(PlayableEnvironmentModel(scene, device=device, seed=0), train_cfg,
                                  environment_model=env_model)
        start = time.perf_counter()
        cache = EncodingCache.build(trainer.encode_batch, train, batch_size=CACHE_BATCH)
        cache_s = time.perf_counter() - start
        cached_frames = cache.encoding.object_style.shape[0]

        def cache_batches(target):
            epoch = 0
            while True:
                yield from cache.iterate_encoding_batches(bs, T, seed=epoch, device=target)
                epoch += 1

        batches = cache_batches(device)
        trainer.init_state_from_encoding(next(batches), seed=0)
        rng = RngStreams(0, device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        fr.fused_rollout_fwd.launches = 0
        fr.fused_rollout_bwd.launches = 0
        step_ms, losses = [], []
        for _ in range(PHASE12_CACHE_STEPS):
            encoding = next(batches)
            start = time.perf_counter()
            metrics = trainer.fused_step(encoding, rng)
            if cuda:
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - start) * 1e3)
            losses.append(metrics["loss"].item())
        cache_launches = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if not all(math.isfinite(x) for x in losses):
            raise SmokeFailure(f"12e losses {losses}")
        if cuda and cache_launches != (2 * PHASE12_CACHE_STEPS, 2 * PHASE12_CACHE_STEPS):
            raise SmokeFailure(f"12e: B4/B5 launches {cache_launches} in {PHASE12_CACHE_STEPS} steps, expected 2 and 2 "
                               "a step (the generator pass of 2 players)")
        # One step card vs CPU, at phase 9's tolerances, on one cache batch.
        host_batch = next(cache.iterate_encoding_batches(bs, T, seed=99, device="cpu"))
        recorded = RecordedStreams(0)
        outputs = []
        for index, dev in enumerate(("cpu", device)):
            step_trainer = PlayableTrainer(PlayableEnvironmentModel(scene, device=dev, seed=1), train_cfg)
            batch_on = host_batch.map(lambda x: x.to(dev))
            step_trainer.init_state_from_encoding(batch_on, seed=0)
            rng_on = recorded if index == 0 else ReplayedStreams(recorded.draws, dev)
            outputs.append(minecraft_phase3_step(step_trainer, batch_on, rng_on))
        (ref_metrics, ref_grads, ref_state, ref_extra), (metrics, grads, state, extra) = outputs
        problems = []
        for name, ref in ref_metrics.items():
            if not abs(metrics[name].item() - ref.item()) <= 1e-3 * abs(ref.item()) + 1e-6:
                problems.append(f"metric {name}: {metrics[name].item():.6e} vs {ref.item():.6e}")
        g_err, g_mean, noise = _compare_grads("G", grads, ref_grads, problems)
        param_err, clear = _compare_parameters("G", state, ref_state, ref_grads, noise, train_cfg.learning_rate,
                                               problems)
        buffer_err = 0.0
        for name in (n for n in ref_state if n not in ref_grads):
            err = (state[name].cpu() - ref_state[name]).abs().max().item() / max(ref_state[name].abs().max().item(),
                                                                                 1e-30)
            buffer_err = max(buffer_err, err)
            if not err <= 1e-3:
                problems.append(f"buffer {name}: err {err:.3e} of its largest")
        extra_err = max((g.cpu() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
                        for g, r in zip(extra, ref_extra))
        if not extra_err <= 1e-3:
            problems.append(f"centroids or MI matrices: err {extra_err:.3e} of their largest")
        if problems:
            for problem in problems[:12]:
                print(f"  12e card vs CPU: {problem}")
            raise SmokeFailure(f"12e card vs CPU Minecraft phase-3 step: {len(problems)} checks failed, first: "
                               f"{problems[0]}")
        median = statistics.median(step_ms[2:])
        out["phase3"] = {
            "cache_frames": cached_frames, "cache_s": cache_s, "cache_frames_per_s": cached_frames / cache_s,
            "launches": cache_launches, "step_ms": step_ms, "median_step_ms": median, "losses": losses,
            "peak_memory_bytes": peak, "card_vs_cpu": {
                "loss": metrics["loss"].item(), "ref_loss": ref_metrics["loss"].item(), "grad_rel_err": g_err,
                "grad_mean_rel_err": g_mean[0], "param_err": param_err, "sign_clear_elements": clear,
                "buffer_err": buffer_err, "extra_err": extra_err},
            "seconds": time.perf_counter() - phase_start,
        }
        print(f"12e Minecraft phase 3 over the encoding cache: {cached_frames} frames encoded in {cache_s:.2f} s "
              f"({cached_frames / cache_s:.1f} frames/s, the learned pose encoder included); "
              f"{PHASE12_CACHE_STEPS} generator steps (minecraft.yaml: no GAN, no discriminators) at bs {bs} x {T}, "
              f"2 players with an animation model each (dynamics 128, style 32): B4 {cache_launches[0]}, B5 "
              f"{cache_launches[1]} launches; median step {median:.3f} ms over steps 3-{PHASE12_CACHE_STEPS}; peak "
              f"memory {peak / 2**20:.1f} MiB; one step card vs CPU: loss {metrics['loss'].item():.6f} vs "
              f"{ref_metrics['loss'].item():.6f}, gradients within {g_err:.3e} of their model's largest (mean "
              f"{g_mean[0]:.3e}), {clear} parameter elements with a clear sign within {param_err:.3e}, running "
              f"statistics within {buffer_err:.3e}, centroids and MI matrices within {extra_err:.3e}")
    return out


# ---- the published phase-2 decoder path and phase 1 (phase 13) ----------------

# Per-card batch of each cell (x its observations): the largest of 8, 4, 2
# whose projected peak stays under 70 GB (PERF.md §4 gives the bs 1 and 2
# peaks it is projected from).
DECODER_BATCH = {"tennis": 2, "minecraft": 4}
DECODER_OBSERVATIONS = {"tennis": 4, "minecraft": 3}
DECODER_STEPS = {"tennis": 6, "minecraft": 4}
DECODER_IMAGE = (288, 512)
PHASE1_BATCH, PHASE1_STEPS = 20, 6
# B3 against plain autograd at a launch of more than 2^20 points, ragged.
B3_LARGE_POINTS = 1_048_576 + 37
# The tiny card-vs-CPU scenes (13a, 13c): frames, patch and batch.
TINY_IMAGE, TINY_PATCH, TINY_BATCH = (48, 64), 8, (2, 2)
PHASE1_SMALL = (4, 64, 64)
# Card vs CPU bounds of 13a, 13c (f32) and 13d (f32 and bf16): the
# arguments of _card_cpu_checks. Both sides of an f32 step run full-precision
# convolutions (ieee_convolutions); measured on an H100 (700 W), the worst
# gradient element sat at 9.4e-5 (tennis), 2.8e-4 (Minecraft), 3.1e-4 (v8)
# and 2.0e-3 (v9) of its model's largest, tensor norms within 9.1e-4
# relative, cosines above 0.999996, the loss within 2.3e-6 relative, the
# running statistics within 1.8e-5 and every parameter element with a
# clear gradient sign within 6e-8. bf16 rounds each convolution's output
# to 8 bits, and the batch norms' backward cancels most of them: there the
# worst element sat at 0.42 of its half's largest, a tensor's norm 0.106
# from the CPU's and its cosine at 0.878, the loss within 3.2e-5 and the
# statistics within 3.3e-2; but each half's gradients were 0.99-1.03 times
# as far from the same step in f32 as the CPU's bf16 ones, which
# `reference_factor` holds. The bounds sit 1.5-5 times above these.
TOLERANCES_13 = {
    "tennis": dict(loss_rtol=1e-5, stats_tol=1e-4, grad_tol=5e-4, norm_tol=2e-3, cosine=0.9999),
    "minecraft": dict(loss_rtol=1e-5, stats_tol=1e-4, grad_tol=1.5e-3, norm_tol=2e-3, cosine=0.9999),
    "phase1_float32": dict(loss_rtol=1e-5, stats_tol=1e-4, grad_tol=5e-3, norm_tol=5e-3, cosine=0.9999),
    "phase1_bfloat16": dict(loss_rtol=5e-4, stats_tol=5e-2, grad_tol=0.75, norm_tol=0.25, cosine=0.8,
                            reference_factor=1.5),
}


def published_phase2_config(repo, name):
    """configs/<name>.yaml with bench.py's phase-2 overrides (_phase2_setup):
    the NeRFs and benders in bf16 with the fused backbone (the only way the
    training path reaches B2/B3); the autoencoder stays in the YAML's f32."""
    from playableenvironments_tpu_torch.cli.common import load_yaml

    cfg = load_yaml(os.path.join(repo, "configs", f"{name}.yaml"))
    for block in cfg["model"]["object_models"]:
        block["compute_dtype"] = "bfloat16"
        block.setdefault("nerf_model", {})["use_fused_backbone"] = True
    return cfg


def tiny_published_config(repo, name):
    """configs/<name>.yaml cut to a tiny scene for the card-vs-CPU steps:
    NeRFs 3x32 with 24 outputs (the autoencoder's 8 + 16 latent channels),
    benders 2x16, style 8 and deformation 4, object encoders on 16x32 and
    16x16 crops, the autoencoder at bottleneck 16 with one block; f32, the
    plain backbone (B2/B3 take widths 128 and 256 only)."""
    from playableenvironments_tpu_torch.cli.common import load_yaml

    cfg = load_yaml(os.path.join(repo, "configs", f"{name}.yaml"))
    model = cfg["model"]
    model["autoencoder"].update(bottleneck_features=16, bottleneck_blocks=1)
    samples = {4: 4, 16: 4, 1: 1, 32: 8}
    for block in model["object_models"]:
        block.update(style_features=8, deformation_features=4,
                     positions_count_coarse=samples[block["positions_count_coarse"]])
        block["nerf_model"].update(layers_width=32, backbone_layers_count=3, skip_layer_idx=2, output_features=24,
                                   position_encoder={"octaves": 3, "append_original": True})
        if "positional" in block.get("ray_bender_model", {}).get("architecture", ""):
            block["ray_bender_model"].update(layers_width=16, layers_count=2, skip_layer_idx=1,
                                             position_encoder={"octaves": 2, "append_original": True,
                                                               "num_steps": 100})
    for block in model["object_encoders"]:
        v5 = block["architecture"].endswith("v5")
        block.update(style_features=8, deformation_features=4, input_size=[16, 32] if v5 else [16, 16])
    for block in model["object_parameters_encoder"]:
        if block.get("architecture", "").endswith("_v4"):
            block.update(input_size=[32, 32])
    return cfg


def fused_launches_a_step(scene):
    """B2 (and B3) launches of one training step: one per object whose
    AdaIN NeRF takes the fused backbone (the skybox runs plain products)."""
    from playableenvironments_tpu_torch.config import ObjectIds

    ids = ObjectIds(scene)
    nerfs = [scene.object_models[ids.model_idx_by_object_idx(i)].nerf for i in range(ids.objects_count)]
    return sum(nerf.kind != "skybox" and nerf.use_fused_backbone for nerf in nerfs)


def minecraft_batch(torch, bs, obs, height, width, device):
    """A Minecraft-shaped batch: random frames from numpy seed 0,
    data.synthetic's Minecraft camera, the two players' boxes below the
    horizon."""
    import numpy as np

    from playableenvironments_tpu_torch.data.batching import Batch
    from playableenvironments_tpu_torch.data.synthetic import MINECRAFT_GEOMETRY

    rng = np.random.default_rng(0)
    frames = torch.zeros(bs, obs, dtype=torch.int32)
    boxes = torch.tensor([[0.35, 0.45, 0.45, 0.75], [0.55, 0.45, 0.65, 0.75]]).expand(bs, obs, 1, 2, 4)
    return Batch(
        observations=torch.from_numpy(rng.random((bs, obs, 1, height, width, 3), np.float32)),
        camera_rotations=torch.tensor(MINECRAFT_GEOMETRY["camera_rotation"]).expand(bs, obs, 1, 3).contiguous(),
        camera_translations=torch.tensor(MINECRAFT_GEOMETRY["camera_translation"]).expand(bs, obs, 1, 3).contiguous(),
        focals=torch.full((bs, obs, 1), MINECRAFT_FOCAL * width / 512),
        bounding_boxes=boxes.contiguous(), bounding_boxes_validity=torch.ones(bs, obs, 1, 2, dtype=torch.bool),
        global_frame_indexes=frames, video_frame_indexes=frames, video_indexes=torch.zeros(bs, dtype=torch.int32),
    ).to(device)


def decoder_batch(torch, name, bs, obs, height, width, device):
    if name == "tennis":
        return phase2_batch(torch, bs, obs, height, width, device)
    return minecraft_batch(torch, bs, obs, height, width, device)


class CountedOverlapFix:
    """Counts the static samples the training composer's overlap fix masks
    (wraps core.compositing.apply_overlap_fix while in a `with`)."""

    def __enter__(self):
        from playableenvironments_tpu_torch.core import compositing

        self.module, self.original, self.masked = compositing, compositing.apply_overlap_fix, 0

        def counting(*args):
            self.masked += int(args[-1].sum())
            return self.original(*args)

        compositing.apply_overlap_fix = counting
        return self

    def __exit__(self, *exc):
        self.module.apply_overlap_fix = self.original


@contextlib.contextmanager
def ieee_convolutions(device):
    """cuDNN's f32 convolutions in full precision inside the `with` (TF32,
    PyTorch's default for them, off), for the card-vs-CPU steps only: the
    main paths keep the defaults. A probe convolution on `device` checks
    that the switch took (TF32 leaves ~1e-3 of the output's largest)."""
    import torch
    import torch.nn.functional as F

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        if torch.device(device).type == "cuda":
            generator = torch.Generator().manual_seed(0)
            x, w = torch.randn(2, 64, 24, 24, generator=generator), torch.randn(64, 64, 3, 3, generator=generator)
            got = F.conv2d(x.to(device), w.to(device)).cpu().double()
            ref = F.conv2d(x.double(), w.double())
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            if not err <= 1e-5:
                raise SmokeFailure(f"convolutions in full precision: a probe is off by {err:.3e} of its largest")
        yield


def _grad_group(name):
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in ("composer", "autoencoder") else parts[0]


def _card_cpu_checks(label, card, host, lr, loss_rtol, stats_tol, grad_tol, norm_tol, cosine,
                     reference=None, reference_factor=None):
    """Card vs CPU of one train step's (loss, metrics, grads, state after).

    - The loss and the metrics to `loss_rtol` relative.
    - Every gradient element to `grad_tol` of its model's largest gradient.
    - Each gradient whose largest is at least 1e-3 of its model's: its norm
      to `norm_tol` relative of the CPU's (a gradient off by a constant
      factor fails), its cosine with the CPU's to `cosine`.
    - Parameters after the Adam step as _compare_parameters holds them,
      with each tensor's card-vs-CPU gradient error for its noise; elements
      whose CPU gradient is under 1e-2 of their model's largest or 1e-4 are
      held to 2 lr only.
    - Running statistics to `stats_tol` of their largest magnitude.
    - With `reference` (the same step on the CPU in float32, for bf16
      steps): each model's gradients, taken together, no farther from the
      reference in relative L2 than `reference_factor` times the CPU's own.

    :return: the worst errors."""
    (loss, metrics, grads, state), (ref_loss, ref_metrics, ref_grads, ref_state) = card, host
    problems = []
    for name, ref in list(ref_metrics.items()) + [("loss", ref_loss)]:
        got = metrics.get(name, loss) if name != "loss" else loss
        if not abs(got.item() - ref.item()) <= loss_rtol * abs(ref.item()) + 1e-6:
            problems.append(f"{name}: {got.item():.6e} vs {ref.item():.6e}")
    if set(grads) != set(ref_grads):
        problems.append("different parameters received gradients")
    scale = {}
    for name, ref in ref_grads.items():
        scale[_grad_group(name)] = max(scale.get(_grad_group(name), 0.0), ref.abs().max().item())
    worst, worst_cos, worst_norm, noise = 0.0, 1.0, 0.0, {}
    for name, ref in ref_grads.items():
        got, ref64 = grads[name].cpu().double(), ref.double()
        noise[name] = (got - ref64).abs().max().item()
        own, model = ref.abs().max().item(), max(scale[_grad_group(name)], 1e-30)
        worst = max(worst, noise[name] / model)
        if not noise[name] <= grad_tol * model:
            problems.append(f"gradient {name}: max err {noise[name] / model:.3e} of its model's largest")
        if own >= 1e-3 * model:
            ratio = got.norm().item() / max(ref64.norm().item(), 1e-300)
            cos = float((got * ref64).sum()) / max(got.norm().item() * ref64.norm().item(), 1e-300)
            worst_norm, worst_cos = max(worst_norm, abs(ratio - 1.0)), min(worst_cos, cos)
            if not abs(ratio - 1.0) <= norm_tol:
                problems.append(f"gradient {name}: norm {ratio:.4f} times the CPU's")
            if not cos >= cosine:
                problems.append(f"gradient {name}: cosine {cos:.5f} with the CPU's")
        if own < 1e-2 * model:
            noise[name] = math.inf  # a gradient of noise has no clear sign for Adam's step
    # Adam's first update is lr g / (|g| + 1e-8): only where |g| >> 1e-8 is
    # it the sign alone (at 1e-6 the epsilon still moves it by 1%).
    param_err, clear = _compare_parameters(label, state, ref_state, ref_grads, noise, lr, problems, floor=1e-4)
    stats_err = 0.0
    for name, ref in ref_state.items():
        if name in ref_grads or not ref.dtype.is_floating_point:
            continue
        err = (state[name].cpu() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        stats_err = max(stats_err, err)
        if not err <= stats_tol:
            problems.append(f"running statistic {name}: err {err:.3e} of its largest")
    reference_ratio = None
    if reference is not None:
        reference_ratio = 0.0
        f32_grads = reference[2]
        for model in scale:
            names = [n for n in f32_grads if _grad_group(n) == model]
            norm = math.sqrt(sum(float(f32_grads[n].double().norm()) ** 2 for n in names))
            card_err = math.sqrt(sum(float((grads[n].cpu().double() - f32_grads[n].double()).norm()) ** 2
                                     for n in names)) / norm
            cpu_err = math.sqrt(sum(float((ref_grads[n].double() - f32_grads[n].double()).norm()) ** 2
                                    for n in names)) / norm
            reference_ratio = max(reference_ratio, card_err / max(cpu_err, 1e-12))
            if not card_err <= reference_factor * cpu_err:
                problems.append(f"{model}'s gradients: {card_err:.3e} from the f32 step's, the CPU's {cpu_err:.3e}")
    if problems:
        for problem in problems[:12]:
            print(f"  {label} card vs CPU: {problem}")
        raise SmokeFailure(f"{label} card vs CPU: {len(problems)} checks failed, first: {problems[0]}")
    return {"loss": loss.item(), "ref_loss": ref_loss.item(), "grad_rel_err": worst, "worst_cosine": worst_cos,
            "worst_norm_ratio_err": worst_norm, "reference_err_ratio": reference_ratio,
            "param_err": param_err, "sign_clear_elements": clear, "stats_err": stats_err, "grads": len(grads)}


def _describe_checks(worst):
    text = (f"{worst['grads']} gradients within {worst['grad_rel_err']:.3e} of their model's largest, norms within "
            f"{worst['worst_norm_ratio_err']:.3e} relative, cosines >= {worst['worst_cosine']:.5f}; "
            f"{worst['sign_clear_elements']} clear parameter elements within {worst['param_err']:.3e}; running "
            f"statistics within {worst['stats_err']:.3e}")
    if worst["reference_err_ratio"] is not None:
        text += f"; {worst['reference_err_ratio']:.3f} times the CPU's distance from the f32 step"
    return text


def _synthesis_step(torch, trainer, batch, rng):
    model = trainer.model
    model.train()
    trainer.optimizer.zero_grad()
    loss, metrics, _ = trainer.compute_losses(batch, rng, trainer.step)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    trainer.optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads, \
        {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase13_decoder_card_vs_cpu(repo, name, devices=("cuda", "cpu")):
    """13a / 13c: one decoder-path step of the tiny `name` scene at 48x64
    (patch 8, strides (4, 8)) on the card and on the CPU from the same
    seeded weights, the patch centres drawn once on the CPU; perturbation
    and the style shuffle off, as phase 6. The autoencoder trains (no
    freeze), so that every group moves."""
    import dataclasses

    import torch

    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer

    cfg = tiny_published_config(repo, name)
    train_cfg = dataclasses.replace(synthesis_training_config(cfg), patch_size=TINY_PATCH, perturb=False,
                                    shuffle_style=False, frozen_autoencoder_steps=0)
    bs, obs = TINY_BATCH
    outputs, masked, recorded = [], [], RecordedStreams(13)
    for i, device in enumerate(reversed(devices)):  # the CPU first: it draws
        model = build_environment_model(cfg, device=device, seed=5)
        batch = decoder_batch(torch, name, bs, obs, *TINY_IMAGE, device)
        rng = recorded if i == 0 else ReplayedStreams(recorded.draws, device)
        with CountedOverlapFix() as fix, ieee_convolutions(device):
            outputs.append(_synthesis_step(torch, SynthesisTrainer(model, train_cfg), batch, rng))
        masked.append(fix.masked)
    host, card = outputs
    # Both sides in f32 with full-precision convolutions (ieee_convolutions);
    # the sums still run in other orders. TOLERANCES_13 says how far apart.
    worst = _card_cpu_checks(f"13{'a' if name == 'tennis' else 'c'} {name}", card, host,
                             train_cfg.learning_rate, **TOLERANCES_13[name])
    if name == "minecraft" and not (masked[0] == masked[1] and masked[0] > 0):
        raise SmokeFailure(f"13c: the overlap fix masked {masked} background samples (card, CPU)")
    worst["masked_background_samples"] = masked[0]
    print(f"13{'a' if name == 'tennis' else 'c'} {name} decoder step card vs CPU ({bs} x {obs} obs, "
          f"{TINY_IMAGE[0]}x{TINY_IMAGE[1]}, patch {TINY_PATCH}): loss {worst['loss']:.6f} vs {worst['ref_loss']:.6f}; "
          f"{_describe_checks(worst)}"
          + (f"; the overlap fix masked {masked[0]} background samples" if name == "minecraft" else ""))
    return worst


def phase13_decoder_main_path(repo, name, batch_size=None, steps=None, device="cuda"):
    """13b / 13c: configs/<name>.yaml's phase 2 at full width through the
    port's synthesis_training_config and build_environment_model (bench.py's
    bf16 fused-backbone overrides), random 288x512 frames at the cell's
    batch, seeded random weights: finite losses, composer parameters moved,
    the autoencoder frozen (its parameters still, the decoder's running
    statistics moved, the encoder's not), B2 and B3 launched once per
    AdaIN object a step; the median step and the peak memory."""
    import statistics as stats_lib

    import torch

    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    bs = batch_size or DECODER_BATCH[name]
    steps = steps or DECODER_STEPS[name]
    obs = DECODER_OBSERVATIONS[name]
    cfg = published_phase2_config(repo, name)
    model = build_environment_model(cfg, device=device, seed=0)
    train_cfg = synthesis_training_config(cfg)
    if not (train_cfg.decode_patches and train_cfg.frozen_autoencoder_steps > steps):
        raise SmokeFailure(f"{name}: the YAML's phase 2 is not the frozen decoder path: {train_cfg}")
    trainer = SynthesisTrainer(model, train_cfg)
    batch = decoder_batch(torch, name, bs, obs, *DECODER_IMAGE, device)
    rng = RngStreams(0, device)
    per_step = fused_launches_a_step(model.scene)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_nerf.fused_backbone_fwd.launches = 0
    fused_nerf.fused_backbone_bwd.launches = 0
    step_ms, losses = [], []
    with CountedOverlapFix() as fix:
        for _ in range(steps):
            start = time.perf_counter()
            metrics = trainer.train_step(batch, rng)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - start) * 1e3)
            losses.append(metrics["loss"].item())
    launches = (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"{name} decoder path losses {losses}")
    state, params = model.state_dict(), dict(model.named_parameters())
    if not all(bool(torch.isfinite(p).all()) for p in params.values()):
        raise SmokeFailure(f"{name} decoder path: a parameter is not finite after {steps} steps")
    moved = lambda names: sum(not torch.equal(state[n], before[n]) for n in names)  # noqa: E731
    composer = [n for n in params if n.startswith("composer.")]
    autoencoder = [n for n in params if n.startswith("autoencoder.")]
    decoder_stats = [n for n in state if n.startswith("autoencoder.decoder.") and n.endswith(("running_mean",
                                                                                             "running_var"))]
    encoder_stats = [n for n in state if n.startswith("autoencoder.encoder.") and n.endswith(("running_mean",
                                                                                             "running_var"))]
    counts = {"composer": (moved(composer), len(composer)), "autoencoder": (moved(autoencoder), len(autoencoder)),
              "decoder_stats": (moved(decoder_stats), len(decoder_stats)),
              "encoder_stats": (moved(encoder_stats), len(encoder_stats))}
    # A player whose box no patch of the batch reaches keeps its NeRF.
    if not (counts["composer"][0] >= 0.5 * len(composer) and counts["autoencoder"][0] == 0
            and counts["decoder_stats"][0] == len(decoder_stats) and counts["encoder_stats"][0] == 0):
        raise SmokeFailure(f"{name} decoder path: moved (of) {counts}; expected the composer's parameters, the "
                           "decoder's statistics, and no autoencoder parameter (frozen) or encoder statistic")
    if launches != (per_step * steps, per_step * steps):
        raise SmokeFailure(f"{name} decoder path: B2/B3 launches {launches} in {steps} steps, expected {per_step} "
                           "each a step")
    median = stats_lib.median(step_ms[2:])
    rays = sum(p * p for p in _patch_sizes(train_cfg))
    largest = bs * obs * rays * max(o.positions_count_coarse for o in model.scene.object_models)
    print(f"13 {name} decoder path (bs {bs} x {obs} obs, {DECODER_IMAGE[0]}x{DECODER_IMAGE[1]}, patch "
          f"{train_cfg.patch_size} at strides "
          f"{train_cfg.patch_strides}: {rays} rays an image, B2/B3 up to {largest} points a launch): {steps} steps, "
          f"B2 {launches[0]} and B3 {launches[1]} launches ({per_step} each a step); median step {median:.3f} ms "
          f"over steps 3-{steps}; all steps ms {[round(t, 3) for t in step_ms]}; losses "
          f"{[round(x, 6) for x in losses]}; moved (of): {counts}; overlap fix masked {fix.masked} background "
          f"samples in {steps} steps; peak memory {peak / 2**30:.3f} GiB")
    return {"batch": bs, "observations": obs, "launches": launches, "launches_a_step": per_step,
            "step_ms": step_ms, "median_step_ms": median, "losses": losses, "peak_memory_bytes": peak,
            "moved": counts, "masked_background_samples": fix.masked, "rays_an_image": rays,
            "largest_launch_points": largest}


def _patch_sizes(train_cfg):
    from playableenvironments_tpu_torch.render.sampling import strided_patch_sizes

    return strided_patch_sizes(train_cfg.patch_size, train_cfg.patch_strides)


def phase13_backbone_kernels(points_b2):
    """B2 against plain_backbone_fwd on every row of the decoder path's
    largest launch (`points_b2`), and B3 against plain_backbone_bwd at
    B3_LARGE_POINTS, twice (bit-identical); times of both, their plain
    versions, the library chains and the bounds."""
    import torch

    from playableenvironments_tpu_torch.ops import fused_nerf

    rows = {}
    cfg, packed, encoded, g_h, g_alpha = phase5_inputs(points_b2, seed=31)
    bf = {k: v.to(torch.bfloat16).requires_grad_() for k, v in packed.items()}
    pe = encoded.shape[1]
    with torch.no_grad():
        h, alpha = fused_nerf.fused_backbone_fwd(cfg, packed, encoded)
        ref_h, ref_alpha = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
        err_h = check_close("B2 decoder path h", h, ref_h, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
        err_a = check_close("B2 decoder path alpha", alpha, ref_alpha, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
        del h, alpha, ref_h, ref_alpha
        ms = cuda_ms(lambda: fused_nerf.fused_backbone_fwd(cfg, packed, encoded), warmup=2, reps=5)
        plain_ms = cuda_ms(lambda: fused_nerf.plain_backbone_fwd(cfg, packed, encoded), warmup=1, reps=3)
        library_ms = cuda_ms(lambda: library_backbone(torch, cfg, bf, encoded), warmup=1, reps=3)
    flops, bytes_, _, _ = backbone_work(cfg, pe, points_b2)
    rows["fwd"] = dict(points=points_b2, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES_PER_S) * 1e3,
                       bound_by="operations" if flops / PEAK_BF16_FLOPS > bytes_ / PEAK_BYTES_PER_S else "bytes",
                       max_abs_err=max(err_h[0], err_a[0]), mean_abs_err=max(err_h[1], err_a[1]))
    print(f"13 B2 at the decoder path's largest launch ({points_b2} points, every row held): max abs err "
          f"{rows['fwd']['max_abs_err']:.3e}, mean {rows['fwd']['mean_abs_err']:.3e}; call {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {rows['fwd']['bound_ms']:.4f} ms")
    del encoded, g_h, g_alpha, bf
    torch.cuda.empty_cache()

    points = B3_LARGE_POINTS
    cfg, packed, encoded, g_h, g_alpha = phase5_inputs(points, seed=32)
    saved = encoded.to(torch.bfloat16)
    bf = {k: v.to(torch.bfloat16).requires_grad_() for k, v in packed.items()}
    with torch.no_grad():
        grads, d_enc = fused_nerf.fused_backbone_bwd(cfg, packed, saved, g_h, g_alpha)
        again, d_enc_again = fused_nerf.fused_backbone_bwd(cfg, packed, saved, g_h, g_alpha)
        if not (torch.equal(d_enc, d_enc_again) and all(torch.equal(grads[k], again[k]) for k in grads)):
            raise SmokeFailure(f"B3 at {points} points: two launches on the same inputs differ")
        del again, d_enc_again
        ref_grads, ref_d_enc = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
        worst = worst_mean = 0.0
        for key, got, ref in [("d_encoded", d_enc, ref_d_enc)] + [(k, grads[k], ref_grads[k]) for k in ref_grads]:
            scale = ref.abs().max().item()
            tol, mean_tol = ((D_ENCODED_REL_ATOL, D_ENCODED_REL_MEAN) if key == "d_encoded"
                             else (GRAD_REL_ATOL, GRAD_REL_MEAN))
            err, mean = check_close(f"B3 {points} {key}", got, ref, tol * scale, 0.0, mean_tol * scale)
            worst, worst_mean = max(worst, err / scale), max(worst_mean, mean / scale)
        del grads, d_enc, ref_grads, ref_d_enc
        bwd_ms = cuda_ms(lambda: fused_nerf.fused_backbone_bwd(cfg, packed, saved, g_h, g_alpha), warmup=2, reps=5)
        bwd_plain_ms = cuda_ms(lambda: fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha),
                               warmup=1, reps=3)
    lib_h, lib_alpha = library_backbone(torch, cfg, bf, encoded)
    cot = [g_h.to(torch.bfloat16), g_alpha.to(torch.bfloat16)]
    bwd_library_ms = cuda_ms(lambda: torch.autograd.backward([lib_h, lib_alpha], cot, retain_graph=True),
                             warmup=1, reps=3)
    del lib_h, lib_alpha
    _, _, flops, bytes_ = backbone_work(cfg, encoded.shape[1], points)
    rows["bwd"] = dict(points=points, ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=bwd_library_ms,
                       bound_ms=max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES_PER_S) * 1e3,
                       bound_by="operations" if flops / PEAK_BF16_FLOPS > bytes_ / PEAK_BYTES_PER_S else "bytes",
                       max_abs_err=worst, mean_abs_err=worst_mean)
    print(f"13 B3 at {points} points (ragged): bit-identical across two launches; max err {worst:.3e}, mean "
          f"{worst_mean:.3e} of each output's largest; call {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms, library "
          f"{bwd_library_ms:.4f} ms, bound {rows['bwd']['bound_ms']:.4f} ms")
    del encoded, saved, g_h, g_alpha, bf
    torch.cuda.empty_cache()
    return rows


def phase1_trainer(variant, dtype, device, perceptual=0.1, seed=0, **ae):
    from playableenvironments_tpu_torch.config import AutoencoderConfig
    from playableenvironments_tpu_torch.train.trainer_autoencoder import (
        AutoencoderTrainer, AutoencoderTrainingConfig,
    )

    return AutoencoderTrainer(AutoencoderConfig(variant=variant, compute_dtype=dtype, **ae),
                              AutoencoderTrainingConfig(perceptual_lambda=perceptual, kl_lambda=5e-6),
                              device=device, seed=seed)


def _phase1_step(trainer, images, rng):
    model = trainer.model
    model.train()
    trainer.optimizer.zero_grad()
    loss, metrics, _ = trainer.compute_losses(images, rng)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    trainer.optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads, \
        {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase13_phase1_card_vs_cpu(devices=("cuda", "cpu")):
    """13d: one phase-1 step (the published widths, perceptual 0.1, KL
    5e-6, VGG19 on its seeded weights) at PHASE1_SMALL on the card and on
    the CPU, v8 and v9, f32 and bf16, the posterior noise drawn once on the
    CPU, at TOLERANCES_13's bounds. A bf16 step is also run on the CPU in
    f32: the card's bf16 gradients must be about as close to those as the
    CPU's bf16 gradients are."""
    import numpy as np
    import torch

    images = torch.from_numpy(np.random.default_rng(1).random(PHASE1_SMALL + (3,), np.float32))
    results = {}
    for variant in ("v8", "v9"):
        for dtype in ("float32", "bfloat16"):
            outputs, recorded = [], RecordedStreams(14)
            for i, device in enumerate(reversed(devices)):  # the CPU first: it draws
                trainer = phase1_trainer(variant, dtype, device)
                rng = recorded if i == 0 else ReplayedStreams(recorded.draws, device)
                with ieee_convolutions(device):
                    outputs.append(_phase1_step(trainer, images.to(device), rng))
            host, card = outputs
            reference = None
            if dtype == "bfloat16":
                reference = _phase1_step(phase1_trainer(variant, "float32", "cpu"), images,
                                         ReplayedStreams(recorded.draws, "cpu"))
            label = f"13d phase 1 {variant} {dtype}"
            worst = _card_cpu_checks(label, card, host, 4e-4, **TOLERANCES_13[f"phase1_{dtype}"],
                                     reference=reference)
            results[f"{variant}_{dtype}"] = worst
            print(f"{label} card vs CPU ({PHASE1_SMALL[0]} x {PHASE1_SMALL[1]}x{PHASE1_SMALL[2]}): loss "
                  f"{worst['loss']:.6f} vs {worst['ref_loss']:.6f}; {_describe_checks(worst)}")
    return results


def phase13_phase1_main_path(batch_size=PHASE1_BATCH, steps=PHASE1_STEPS, image=DECODER_IMAGE, device="cuda"):
    """13e: bench.py's phase-1 step (_phase1_setup: the v8 autoencoder at
    the published widths in bf16, perceptual 0.1, KL 5e-6, bs 20 of
    288x512 random images from numpy seed 0, VGG19 on seeded random
    weights): finite, parameters and statistics moved, the VGG unchanged;
    the median step and the peak memory."""
    import statistics as stats_lib

    import numpy as np
    import torch

    from playableenvironments_tpu_torch.utils.random import RngStreams

    trainer = phase1_trainer("v8", "bfloat16", device)
    images = torch.from_numpy(np.random.default_rng(0).random((batch_size,) + tuple(image) + (3,), np.float32)).to(
        device)
    rng = RngStreams(0, device)
    model = trainer.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    vgg_before = {k: v.detach().clone() for k, v in trainer.vgg.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(steps):
        start = time.perf_counter()
        metrics = trainer.train_step(images, rng)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        losses.append({k: v.item() for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated()
    state, params = model.state_dict(), dict(model.named_parameters())
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise SmokeFailure(f"phase-1 losses {losses}")
    moved_params = sum(not torch.equal(state[n], before[n]) for n in params)
    stats = [n for n in state if n.endswith(("running_mean", "running_var"))]
    moved_stats = sum(not torch.equal(state[n], before[n]) for n in stats)
    vgg_still = all(torch.equal(v, vgg_before[k]) for k, v in trainer.vgg.state_dict().items())
    if moved_params < 0.95 * len(params) or moved_stats < len(stats) or not vgg_still:
        raise SmokeFailure(f"phase 1: {moved_params}/{len(params)} parameters and {moved_stats}/{len(stats)} "
                           f"statistics moved, VGG unchanged: {vgg_still}")
    median = stats_lib.median(step_ms[2:])
    print(f"13e phase-1 step (v8 bf16, bs {batch_size} x {image[0]}x{image[1]}, perceptual 0.1, KL 5e-6): {steps} "
          f"steps; median step {median:.3f} ms over steps 3-{steps}; all steps ms {[round(t, 3) for t in step_ms]}; "
          f"losses {[round(m['loss'], 6) for m in losses]}; {moved_params}/{len(params)} parameters and "
          f"{moved_stats}/{len(stats)} statistics moved, VGG unchanged; peak memory {peak / 2**30:.3f} GiB")
    return {"step_ms": step_ms, "median_step_ms": median, "losses": losses, "peak_memory_bytes": peak,
            "batch": batch_size}


def phase13(repo):
    """13a-13e (module docstring); the B2/B3 checks at the decoder path's
    shapes first, while the card holds nothing else."""
    from playableenvironments_tpu_torch.cli.common import synthesis_training_config
    from playableenvironments_tpu_torch.config import scene_from_dict

    results = {}
    tennis_cfg = published_phase2_config(repo, "tennis")
    scene = scene_from_dict(tennis_cfg["model"], tennis_cfg.get("playable_model"))
    rays = sum(p * p for p in _patch_sizes(synthesis_training_config(tennis_cfg)))
    largest = DECODER_BATCH["tennis"] * DECODER_OBSERVATIONS["tennis"] * rays * max(
        o.positions_count_coarse for o in scene.object_models)
    results["kernels"] = phase13_backbone_kernels(largest)
    results["tennis_card_vs_cpu"] = phase13_decoder_card_vs_cpu(repo, "tennis")
    results["tennis"] = phase13_decoder_main_path(repo, "tennis")
    results["minecraft_card_vs_cpu"] = phase13_decoder_card_vs_cpu(repo, "minecraft")
    results["minecraft"] = phase13_decoder_main_path(repo, "minecraft")
    results["phase1_card_vs_cpu"] = phase13_phase1_card_vs_cpu()
    results["phase1"] = phase13_phase1_main_path()
    return results


def ptxas_entries(report: str) -> dict:
    """{kernel entry (mangled): {"registers", "spill_stores", "spill_loads",
    "smem"}} from nvcc -Xptxas -v output."""
    import re

    entries, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entries[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entries[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entries[name]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                entries[name]["smem"] = int(m.group(1)) if m else 0
    return entries


def phase2_adain_kernels(scene, reports, device="cuda"):
    """B1 at the tennis frame's four objects (each its own seeded weights):
    each object alone through fused_adain_nerf, then the frame as one
    grouped launch (fused_adain_nerf_group), each held object by object
    against plain_adain_nerf; times of kernel, plain version, library
    chain and bound per object, and of the grouped launch; the weight-image
    bytes a frame from L2, the clusters placed at once and ptxas's report
    for the kernel. Returns (per-object rows, the group's row)."""
    import torch

    from playableenvironments_tpu_torch.models.encoding import positional_encoding
    from playableenvironments_tpu_torch.models.layers import initialize_
    from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
    from playableenvironments_tpu_torch.ops import fused_nerf

    cfg = scene.object_models[0].nerf
    generator = torch.Generator().manual_seed(0)
    shapes, items, refs = [], [], []
    for name, rays, samples in TENNIS_LAUNCHES:
        nerf = AdaInNerfMLP(cfg, scene.object_models[0].style_features, device=device)
        initialize_(nerf, generator)
        weights = nerf.kernel_weights()
        bf16_weights = {k: v.to(torch.bfloat16) for k, v in weights.packed.items()}
        points = rays * samples
        positions = torch.rand(points, 3, generator=generator) * 2.0 - 1.0
        encoded = positional_encoding(positions, cfg.position_encoder.octaves, True)
        encoded = encoded.to(device=device, dtype=torch.bfloat16)
        style = torch.randn(rays, 64, generator=generator).to(device)
        with torch.no_grad():
            s0, b0 = fused_nerf.fold_adain_stats(nerf.adain_0, style)
            s1, b1 = fused_nerf.fold_adain_stats(nerf.adain_1, style)
            args = (encoded, s0, b0, s1, b1)
            items.append(fused_nerf.AdaInNerfItem(weights, *args, samples))
            feats, alpha = fused_nerf.fused_adain_nerf(cfg, weights, *args, samples_per_ray=samples)
            torch.cuda.synchronize()
            refs.append(fused_nerf.plain_adain_nerf(cfg, weights.packed, *args, samples))
            errs = [check_close(f"B1 {name} {out}", got, ref, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
                    for out, got, ref in zip(("features", "alpha"), (feats, alpha), refs[-1])]
            rel = max((got - ref).abs().div(ref.abs().clamp(min=1e-3)).max().item()
                      for got, ref in zip((feats, alpha), refs[-1]))
            ms = cuda_ms(lambda: fused_nerf.fused_adain_nerf(cfg, weights, *args, samples_per_ray=samples))
            plain_ms = cuda_ms(lambda: fused_nerf.plain_adain_nerf(cfg, weights.packed, *args, samples))
            library_ms = cuda_ms(lambda: library_mlp(cfg, bf16_weights, *args, samples))
        flops, bytes_ = mlp_work(cfg, weights.packed, points, rays)
        bound_ms = max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES_PER_S) * 1e3
        shapes.append({
            "object": name, "rays": rays, "samples": samples, "points": points,
            "max_abs_err": max(e[0] for e in errs), "max_rel_err": rel, "mean_abs_err": max(e[1] for e in errs),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS > bytes_ / PEAK_BYTES_PER_S else "bytes",
            "gflop": flops / 1e9, "mbytes": bytes_ / 1e6,
        })
        print(
            f"B1 {name} alone ({rays} rays x {samples} = {points} points): "
            f"max abs err {shapes[-1]['max_abs_err']:.3e}, max rel err {rel:.3e}, "
            f"mean abs err {shapes[-1]['mean_abs_err']:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({shapes[-1]['bound_by']}), {flops / ms / 1e9:.1f} TFLOP/s"
        )

    # The frame's four objects in one grouped launch.
    with torch.no_grad():
        launches, objects = fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects
        outs = fused_nerf.fused_adain_nerf_group(cfg, items)
        torch.cuda.synchronize()
        if (fused_nerf.fused_adain_nerf.launches - launches, fused_nerf.fused_adain_nerf.objects - objects) != (
                1, len(items)):
            raise SmokeFailure("the grouped B1 call did not make one launch covering the frame's objects")
        errs = []
        for (name, _, _), (feats, alpha), ref in zip(TENNIS_LAUNCHES, outs, refs):
            errs += [check_close(f"B1 group {name} {out}", got, r, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
                     for out, got, r in zip(("features", "alpha"), (feats, alpha), ref)]
        group_ms = cuda_ms(lambda: fused_nerf.fused_adain_nerf_group(cfg, items))
        back_to_back_ms = cuda_ms_back_to_back(lambda: fused_nerf.fused_adain_nerf_group(cfg, items))
    total = {k: sum(r[k] for r in shapes) for k in ("ms", "plain_ms", "library_ms", "bound_ms", "gflop")}
    lib = fused_nerf._library()
    ctas = lib.fused_adain_nerf_cluster_size()
    out_features = items[0].weights.packed["w_out"].shape[1]
    clusters = lib.fused_adain_nerf_max_clusters(cfg.layers_width, out_features)
    table = fused_nerf.adain_pair_table([r["points"] for r in shapes], ctas)
    image_bytes = items[0].weights.image.numel() * 2
    group = {
        "ms": group_ms, "back_to_back_ms": back_to_back_ms, "max_abs_err": max(e[0] for e in errs),
        "mean_abs_err": max(e[1] for e in errs),
        "single_ms": total["ms"], "plain_ms": total["plain_ms"], "library_ms": total["library_ms"],
        "bound_ms": total["bound_ms"], "tflops": total["gflop"] / group_ms, "cluster_ctas": ctas,
        "clusters": clusters, "pairs": table[-1], "image_bytes": image_bytes,
        "l2_weight_bytes": table[-1] * image_bytes,
        "ptxas": {k: v for k, v in ptxas_entries(reports.get("fused_nerf.cu", "")).items()
                  if "adain_nerf_kernel" in k},
    }
    if clusters <= 0:
        raise SmokeFailure(f"fused_adain_nerf_max_clusters returned {clusters}")
    print(
        f"B1 grouped frame (4 objects, {table[-1]} units of {ctas} tiles on {min(clusters, table[-1])} clusters of "
        f"{ctas} CTAs; the card places {clusters} at once): max abs err {group['max_abs_err']:.3e}, mean abs err "
        f"{group['mean_abs_err']:.3e}; grouped launch {group_ms:.4f} ms ({group['tflops']:.1f} TFLOP/s, "
        f"{100 * total['bound_ms'] / group_ms:.1f}% of the bf16 bound; {back_to_back_ms:.4f} ms a launch back to back), "
        f"one launch per object {total['ms']:.4f} ms, "
        f"library chain {total['library_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
        f"bound {total['bound_ms']:.4f} ms; weight image {image_bytes} B, {group['l2_weight_bytes'] / 1e9:.3f} GB "
        f"a frame from L2"
    )
    for entry, info in group["ptxas"].items():
        print(f"  ptxas adain_nerf_kernel {entry}: {info}")
    return shapes, group


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
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.render.fast import frame_rays, render_rays_fast

    device = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # Seconds of each phase, from the end of the one before.
    phase_seconds, clock = {}, [time.perf_counter()]

    def done(phase):
        clock.append(time.perf_counter())
        phase_seconds[phase] = round(clock[-1] - clock[-2], 1)

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

    done("1")
    alone = {"12": phase12_minecraft, "13": phase13}
    if len(sys.argv) == 3 and sys.argv[1] == "--phase" and sys.argv[2] in alone:
        try:
            result = alone[sys.argv[2]](repo)
        except SmokeFailure as e:
            return fail(str(e))
        os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
        with open(os.path.join(repo, "chiprun_out", f"chip_smoke_phase{sys.argv[2]}.json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        print(f"phase {sys.argv[2]} alone: passed")
        return 0

    # ---- 2. B1 vs plain version: each tennis object alone, then the frame's grouped launch
    scene = scene_from_yaml(os.path.join(repo, "configs", "tennis.yaml"))
    try:
        shapes, group = phase2_adain_kernels(scene, reports)
    except SmokeFailure as e:
        return fail(str(e))

    done("2")

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

    done("3")

    # ---- 4. the main path: the tennis play loop at 512x288 ----------------
    session = InteractiveSession.from_scene(
        scene, image_size=IMAGE_SIZE, patch_strides=STRIDES,
        focal_length_multiplier=FOCAL_LENGTH_MULTIPLIER, device="cuda", seed=0,
    )
    encoding = tennis_encoding(torch, device)
    fused_nerf.fused_adain_nerf.launches = 0
    fused_nerf.fused_adain_nerf.objects = 0
    frames = [session.start(encoding)]
    step_ms = []
    for i in range(STEPS):
        start = time.perf_counter()
        frames.append(session.step(list(ACTIONS[i % len(ACTIONS)])))
        step_ms.append((time.perf_counter() - start) * 1e3)
    launches, objects = fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects
    for i, frame in enumerate(frames):
        if frame.shape != (IMAGE_SIZE[0], IMAGE_SIZE[1], 3):
            return fail(f"frame {i} has shape {frame.shape}")
        if not np.isfinite(frame).all() or frame.min() < 0.0 or frame.max() > 1.0:
            return fail(f"frame {i} is not finite or leaves [0, 1]")
    if (launches, objects) != (len(frames), len(TENNIS_LAUNCHES) * len(frames)):
        return fail(f"{launches} B1 launches covering {objects} objects for {len(frames)} frames, expected one "
                    f"grouped launch of {len(TENNIS_LAUNCHES)} objects per frame")
    steady = step_ms[2:]
    frame_ms = statistics.median(steady)
    print(
        f"play loop 512x288: {len(frames)} frames, {launches} grouped B1 launches covering {objects} objects; "
        f"median step {frame_ms:.3f} ms ({1e3 / frame_ms:.2f} fps) over steps 3-{STEPS}; "
        f"all steps ms {[round(t, 3) for t in step_ms]}"
    )

    done("4")

    # ---- 5-7. phase-2 training, 8-10. phase-3 training, 11. data, 12. Minecraft
    try:
        fwd_rows, bwd_rows = phase5_backbone_kernels()
        done("5")
        card_vs_cpu = phase6_card_vs_cpu()
        done("6")
        phase2 = phase7_main_path()
        done("7")
        rollout_rows, rollout_timing = phase8_rollout_kernels()
        done("8")
        phase3_card_vs_cpu = phase9_card_vs_cpu()
        done("9")
        phase3 = phase10_main_path()
        done("10")
        phase11 = phase11_from_data(repo, scene, frame_ms, phase3["median_step_ms"])
        done("11")
        phase12 = phase12_minecraft(repo)
        done("12")
        phase13_results = phase13(repo)
        done("13")
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

    # B1: one grouped launch a frame; plain, library and bound summed over
    # the frame's four objects.
    b1 = kernel_entry("fused_adain_nerf", "fused_nerf.cu", "playableenvironments_tpu/ops/fused_nerf.py:111",
                      launches, shapes)
    mc = phase12["b1"]
    b1.update(ms=group["ms"], max_abs_err=max(b1["max_abs_err"], group["max_abs_err"], phase11["creator"]["b1_max_abs_err"],
                                              mc["frame"]["max_abs_err"], mc["batch4"]["max_abs_err"]),
              launches_by_path={"play": launches, "play_from_batch": phase11["play"]["launches"],
                                "reconstruction": phase11["creator"]["launches"],
                                "minecraft_play": phase12["play"]["launches"],
                                "minecraft_play_from_batch": phase12["data"]["play_launches"],
                                "minecraft_reconstruction": phase12["data"]["creator_launches"][0]},
              batch4_ms=phase11["creator"]["b1_ms"], batch4_bound_ms=phase11["creator"]["b1_bound_ms"],
              minecraft={k: mc["frame"][k] for k in ("points", "ms", "back_to_back_ms", "plain_ms", "library_ms",
                                                      "bound_ms", "bound_by", "max_abs_err")},
              minecraft_batch4={k: mc["batch4"][k] for k in ("points", "ms", "back_to_back_ms", "bound_ms")})
    kernels = [
        b1,
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
    # B2/B3 on the phase-2 decoder paths of both published configs (phase
    # 13): their launches there, and each kernel held and timed at that
    # path's largest launch (B2) and at more than 2^20 points (B3).
    for entry, which in zip(kernels[1:3], ("fwd", "bwd")):
        row = phase13_results["kernels"][which]
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
        entry["launches_by_path"] = {
            "phase2": entry["launches"],
            "tennis_decoder": phase13_results["tennis"]["launches"][which == "bwd"],
            "minecraft_decoder": phase13_results["minecraft"]["launches"][which == "bwd"],
        }
        entry["decoder_path_launch"] = {k: row[k] for k in ("points", "ms", "plain_ms", "library_ms", "bound_ms",
                                                            "bound_by", "max_abs_err")}
    p11 = phase11["phase3"]
    for entry, which in zip(kernels[3:], (0, 1)):
        entry["launches_by_path"] = {"phase3": phase3["launches"][which], "phase3_cache": p11["cache_launches"][which],
                                     "phase3_batch": p11["batch_launches"][which],
                                     "minecraft_phase3_cache": phase12["phase3"]["launches"][which]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "shapes": shapes, "group": group, "step_ms": step_ms, "frame_ms": frame_ms,
                   "backbone_fwd_shapes": fwd_rows, "backbone_bwd_shapes": bwd_rows,
                   "train_card_vs_cpu": card_vs_cpu, "phase2": phase2, "rollout_shapes": rollout_rows,
                   "phase3_card_vs_cpu": phase3_card_vs_cpu, "phase3": phase3, "phase11": phase11, "phase12": phase12,
                   "phase13": phase13_results,
                   "kernels": kernels,
                   "phase_seconds": phase_seconds, "ptxas": reports}, f, indent=1)
    print(f"phase seconds: {phase_seconds}")
    print(
        "tf32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} (PyTorch defaults; the port sets neither)"
    )
    print("kernel ms/plain_ms/library_ms/bound_ms are per frame for fused_adain_nerf (ms: its one grouped launch; "
          "plain, library and bound: sums over the frame's four objects) or sums over the launches of "
          "one train step (the others: the four phase-2 shapes for fused_backbone_fwd/bwd; 2 + 2 B4 and 2 B5 "
          "launches of the phase-3 shape); fused_backbone_fwd/bwd ms are whole wrapper calls as the autograd "
          "Function makes them (the forward's weight-image build included; phase 5 prints the kernels' own "
          "times beside them); max_abs_err of fused_backbone_bwd and fused_rollout_fwd/bwd is "
          "relative to each output's largest magnitude; fused_adain_nerf's `minecraft` is the Minecraft frame's one "
          "grouped launch of 3 objects (phase 12a; plain, library and bound summed over them) and "
          "`minecraft_batch4` the creator's batch of 4; fused_backbone_fwd/bwd's `decoder_path_launch` is one launch "
          "at the phase-2 decoder path's largest shape (B2) and at 1,048,613 points (B3), phase 13; "
          "fused_rollout bounds use the f32 peak "
          f"({PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), the others the bf16 one ({PEAK_BF16_FLOPS / 1e12:.0f})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
