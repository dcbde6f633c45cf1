#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: the tennis play loop, the
tennis phase-2 train step, the tennis phase-3 (action module) G+D step, the
data path from a dataset on disk to each of them, the Minecraft family, the
published training pipeline (phase 2's decoder path for tennis and
Minecraft, phase 1), phase 2's options and consistency passes, the chain of
the three phases and play through checkpoints, that chain through the
CLIs with their evaluators and a reference checkpoint's import, and the
paper's evaluation protocol (the creators, evaluators and fid, the player
detector, LPIPS, I3D and the metric-weight validation) from the command
line.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. build the port's CUDA kernels (csrc/fused_nerf.cu, csrc/fused_backbone.cu,
   csrc/fused_backbone_f32.cu, csrc/fused_rollout.cu), one nvcc per source,
   started together;
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
6. one train step of the phase-2 scene at 288x512 on the card and on the
   CPU from the same seeded weights, randomness off, with full-precision
   convolutions on both (ieee_convolutions): loss, metrics, gradients,
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
   KL 5e-6) for 6 steps. Each path prints its median step and peak memory;
14. phase 2 with the reference's options (use_fine with separate fine
   fields, the divergence loss, per-frame camera offsets at their own
   rate, remat): (a) B2/B3 for f32 operands (csrc/fused_backbone_f32.cu,
   3xTF32) at the direct-ray shapes, a ragged launch and 14c's fine-pass
   launch: the weight images against their plain version bit for bit, B2
   against its plain version, B3 twice (bit-identical) against the f64
   backward at the kernel's ReLU pattern; timed beside the f32
   torch.matmul chain, the FP32 and 3xTF32 bounds; (b) one tiny decoder-path
   step with every option on, card vs CPU on the CPU's draws in
   full-precision convolutions, then the card's step without remat
   against it; (c) configs/tennis.yaml's phase 2 at full width with every
   option on and the fused backbone at the YAML's f32 (B2-f32, B3-f32 and
   image-build launches a step counted, the recompute's included), median step and
   peak; (d) remat's peaks and steps on 13b's path at bs 2 x 4 off and
   on, the largest batch under 70 GB with it, phase 1 at bs 20 off and on;
   (e) a use_fine model's frames through the composer-based path
   (FrameRenderer(use_fast=False)): 48x64 card vs CPU and 512x288 timed;
15. phase 2's consistency passes and the published chain through
   checkpoints: (a) 13b's tennis decoder path (bs 2 x 4, 288x512) with pose
   consistency 1.0, keypoint consistency 1.0 and keypoint opacity 0.1 on a
   hand-made optical flow and 17 COCO keypoints a player, against the same
   path without them in one process: median steps, peak memory, B2/B3
   launches a step (one B2 a field call of the passes, one B3 a keypoint
   call) and the points the passes add, the metrics finite, then B2/B3
   held against their plain versions on the inputs of each shape one more
   step gives them, the passes' calls among them; (b) 13a's tiny
   tennis step with the three weights on, card vs CPU on the CPU's draws
   in full-precision convolutions, at TOLERANCES_15; (c) in a temporary
   directory, phase 1 (2 steps, saved) -> phase 2 at bs 1 x 4 (the phase-1
   autoencoder grafted bit for bit, 2 steps, keep=2 pruning) -> its
   restore into a fresh trainer (bit for bit) -> phase 3 from
   restore_params (2 fused steps, saved, restored bit for bit: both
   optimizers, centroids, MI matrices) -> play from the restored models
   (3 frames against the in-memory models'), and one resumed phase-2 step
   with deterministic algorithms against the uninterrupted one and an
   in-memory copy's (0 apart), B2/B3 held on the inputs of that step's
   shapes (B3's weight gradients against f64 in units of their rounding
   scale); checkpoint bytes, save and restore ms.
16. the training, play and import CLIs, each main() called in this process
   with sys.argv set, in a temporary directory, on phase 11's dataset and
   configs/tennis.yaml at full width (PHASE16_*: the fused backbone on,
   depths and cadences cut): (a) train_autoencoder at bs 20 images, 3
   steps, its checkpoints, quick saves and AutoencoderEvaluator grid; (b)
   train on the decoder path (B2-f32/B3-f32) with PyTorch's default
   algorithms, 16a's checkpoint grafted (bit for bit) and evaluated by the
   TrainingEvaluator; (c) with deterministic algorithms, the same run
   stopped at step 3 and resumed to 4, its checkpoint equal bit for bit to
   an uninterrupted 4-step run's; (d) train_playable at bs 16 in
   blocks of 2 steps past max_steps 5 to 6, the PlayableModelEvaluator at
   steps 2, 4 and 6, then a second run that reloads the encoding cache, and
   B4 at the evaluator's rollout_single shape against its plain version;
   (e) play --script from 16b's and 16d's checkpoints, its frames equal bit
   for bit to an in-memory session of the restored models, its first B1
   launch held against plain_adain_nerf; (f) the same models written in
   the reference's torch.save layout (tests/torch_port_reference_layout.py),
   imported with import_checkpoint --phase3 and played: the frames equal
   16e's bit for bit. Each CLI's wall time (startup, steps, saves,
   evaluation), peak memory and B1-B5 launches.
17. the evaluation protocol from the command line, on 16's checkpoints and
   phase 11's test split (2 videos x 12 frames, 288x512): (a)
   generate_reconstructed_dataset, generate_reconstructed_camera_manipulation_dataset
   and generate_reconstructed_playability_dataset (windows of 4) on the
   card, then each creator's first window on the CPU from the same
   checkpoints (the playability creator draws on the host on both): frames
   card vs CPU before and after quantization, B1's first launch of each
   creator (also: the kernel no further than PHASE17_B1_F64_RATIO times
   the plain version from the f64 sums) and B4's first call held against
   their plain versions on those inputs, B1 launched by every creator and B4 by the playability one
   (counts zeroed before, read after); (b) the four evaluate_* CLIs
   (masked-MSE windows and FVD clips of 4) and fid on the card's trees, on
   the card and on the CPU, every result held card vs CPU
   (PHASE17_METRIC_RTOL). Each CLI's wall time, its seconds split (the
   creators' steps; the evaluators' decode, metrics and networks), frames
   a second, peak memory and B1-B5 launches.
18. evaluation finished, on 16's dataset and 17's reconstructed tree: (a)
   one detector step (base_features 32, bs 8 x 288x512) card vs CPU from
   the same weights and batch in full-precision convolutions
   (TOLERANCES_18), then train_detector on the card for PHASE18_STEPS
   steps with one val evaluation: its loss falls, ms a step, peak; (b)
   evaluate_reconstructed_dataset --detector_checkpoint on 17's tree, card
   and CPU (MDR, ADD), and the evaluator built in code with LPIPS and a
   VGG19 from synthesized published-layout states, card vs CPU
   (PHASE18_METRIC_RTOL); (c) validate_metric_weights on the card (every
   golden PASS, each one's largest relative gap printed), and I3D alone on
   one 1 x 16 x 224 x 224 clip card vs CPU, timed, its peak.
`python3 chip_smoke.py --phase 12` (or `--phase 13` to `--phase 18`; 17 runs
16's CLIs first for their checkpoints, 18 both 16 and 17) builds the
kernels and runs that phase alone (no kernels line, no contract line).
Details go to chiprun_out/chip_smoke.json. Prints one JSON line of kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

# nvcc's reports of this run's builds, by source (main fills it).
BUILD_REPORTS = {}
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
# B3 on a main path's own inputs (hold_recorded_backbone_calls): there the
# cotangents are small and a weight gradient can cancel to far below its
# terms (15c's layer-7 gradient: a largest magnitude under 1.94e-5 from
# 655,360 points' products), and a unit may be active at a few points
# only, so an output's largest magnitude says nothing of the rounding it
# carries. Each output element is held against the f64 backward at the
# kernels' own layer outputs (B2 over the first layers,
# backbone_layer_outputs: B3's recompute, its ReLU pattern and bf16
# layer inputs), in units of its rounding scale s = sum |x| |g|
# (plain_backbone_bwd(magnitudes=True)): BF16_GRAD_BAND element-wise and
# BF16_GRAD_BAND_MEAN in the mean. There the two differ only where a
# cotangent, summed in f32 by the kernel and in f64 here, rounds to the
# other bf16 neighbour: one ulp, at most 2^-7 of it, in a term's own
# cotangent and in the one it was carried back from, so 2^-6 of s; and in
# the mean, such a move in one term of 64.
BF16_GRAD_BAND, BF16_GRAD_BAND_MEAN = 2.0 ** -6, 2.0 ** -12
# Per-step launch shapes of the phase-2 step (bs 8 x 4 obs x 144 rays =
# 4,608 rays): (object, points), one B2 and one B3 launch each.
PHASE2_LAUNCHES = (("background", 4608 * 4), ("backplate", 4608 * 4),
                   ("player_1", 4608 * 32), ("player_2", 4608 * 32))
PHASE2_RAGGED = 1000  # not a multiple of the kernels' 128-point tile
PHASE2_STEPS = 6
PHASE6_GRAD_BOUND = 0.12  # of a model's largest gradient; phase6_card_vs_cpu says why


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


def library_backbone(torch, cfg, bf, encoded, dtype=None):
    """The backbone + alpha head as a chain of torch.matmul calls over the
    weights `bf` (requiring grad) in `dtype` (default bf16): the yardstick
    `library_ms` of B2, and its torch.autograd backward that of B3 (f32
    for the f32 kernels of phase 14, which PyTorch runs without TF32 by
    default). Timed only; the port never calls it."""
    enc = encoded.to(dtype or torch.bfloat16)
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


def phase5_inputs(points: int, seed: int = 2, compute_dtype: str = "bfloat16", device="cuda"):
    """(cfg, packed weights, encodings, g_h, g_alpha) on the card for one
    B2/B3 launch at the tennis widths (bf16 operands, or f32 ones for the
    kernels of phase 14): seeded random weights (biases non-zero, so that
    no ReLU input is exactly 0), PE of random points in [-1, 1], random
    cotangents."""
    import torch

    from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig
    from playableenvironments_tpu_torch.models.encoding import positional_encoding
    from playableenvironments_tpu_torch.models.layers import initialize_
    from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP

    cfg = NerfMLPConfig(layers_width=256, backbone_layers_count=8, output_features=3, skip_layer_idx=4,
                        position_encoder=PositionalEncoderConfig(octaves=10), compute_dtype=compute_dtype,
                        use_fused_backbone=True)
    generator = torch.Generator().manual_seed(seed)
    nerf = initialize_(AdaInNerfMLP(cfg, 64, device=device), generator)
    with torch.no_grad():
        for i in range(cfg.backbone_layers_count):
            getattr(nerf, f"backbone_{i}").bias.copy_(torch.randn(256, generator=generator) * 0.1)
    packed = {k: v.detach().contiguous() for k, v in nerf.backbone_params().items()}
    encoded = positional_encoding(torch.rand(points, 3, generator=generator) * 2.0 - 1.0, 10, True).to(device)
    g_h = (torch.randn(points, 256, generator=generator) * 1e-3).to(device)
    g_alpha = (torch.randn(points, generator=generator) * 1e-3).to(device)
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


def phase6_readings(scene, convolutions, devices=("cuda", "cpu")):
    """One train step of `scene` at 1 x 2 observations of 288x512,
    randomness off (the strided grid of strides 8 and 16, 2,880 rays an
    image; no perturbation, no style shuffle), on each device from the same
    seeded weights, inside `convolutions(device)`. (Weighted sampling draws
    the same numbers on both devices, but its inverse CDF, a cumulative sum
    over 147,456 pixels taken in another order on the card, moves a few
    draws to a neighbouring pixel.) :return: the readings of the first
    device against the second, and "problems": those outside phase 6's
    bounds (phase6_card_vs_cpu)."""
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
        model = EnvironmentModel(scene, device=device, seed=3)
        batch = phase2_batch(torch, 1, 2, 288, 512, device)
        with convolutions(device):
            outputs.append(_train_step_outputs(torch, SynthesisTrainer(model, cfg), batch, RngStreams(0, device)))
    (loss, metrics, grads, state), (ref_loss, ref_metrics, ref_grads, ref_state) = outputs
    problems = []
    metric_err = 0.0
    for name, got in list(metrics.items()) + [("loss", loss)]:
        ref = ref_metrics.get(name, ref_loss)
        metric_err = max(metric_err, abs(got.item() - ref.item()) / (abs(ref.item()) + 1e-30))
        if not abs(got.item() - ref.item()) <= 1e-3 * abs(ref.item()) + 1e-6:
            problems.append(f"{name}: {got.item():.6e} vs {ref.item():.6e}")
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
    problems += [f"gradient {r[2]}: max err {r[0]:.3e} of its model's largest gradient, mean err {r[1]:.3e} "
                 "of its own" for r in rel if not (r[0] <= PHASE6_GRAD_BOUND and r[1] <= 0.1)]
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
    return {"worst_gradients": rel[:4], "worst_gradient": rel[0][2], "metric_rel_err": metric_err,
            "loss": loss.item(), "ref_loss": ref_loss.item(), "grad_rel_err": rel[0][0],
            "grad_mean_rel_err": max(r[1] for r in rel), "param_err": param_err, "sign_clear_elements": clear_count,
            "stats_err": stats_err, "grads": len(grads), "problems": problems}


def phase6_card_vs_cpu(devices=("cuda", "cpu")):
    """phase6_readings of the phase-2 scene with B2/B3 on the card, both
    steps inside ieee_convolutions, held to phase 6's bounds."""
    # The card runs B2/B3 (bf16 roundings that flip against the CPU's; see
    # GRAD_REL_ATOL). Loss and metrics are held to 1e-3 relative.
    # Gradients: the backplate's encoder normalizes, in its last blocks, 16
    # values a channel (1 x 8 maps of 2 crops), so a convolution's error
    # comes out amplified. With cuDNN's TF32 convolutions (PyTorch's
    # default, ~1e-3 relative) it reached 1.04e-1 of that encoder's largest
    # gradient in single elements on the card; inside ieee_convolutions, as
    # this step is taken, 3.5e-2, and the largest element error of any
    # tensor is 5.97e-2 of its model's largest, in the ray bender's output
    # head, 6.14e-2 with the plain backbone on both devices (no B2/B3), so
    # neither TF32 nor B2/B3 sets it (scripts/phase6_bound.py, NVIDIA H100
    # 80GB HBM3, 700.00 W). So each gradient tensor is held to 0.12 of the
    # largest gradient magnitude of its model (object_model_i or
    # object_encoder_i) element-wise, twice that reading, and to 0.1 of its
    # own largest magnitude in the mean (mean errors up to 4.4e-2 of a
    # tensor's own largest). The running statistics, batch means and
    # variances of bf16 products on both sides, to 2e-2 of each buffer's
    # largest magnitude (a mean near 0 is a difference of near-equal sums).
    # Parameters after the step: Adam's first update is lr g / (|g| + 1e-8),
    # about lr sign(g) where |g| >> 1e-8, so every element whose CPU gradient
    # exceeds 1e-5 and twice its tensor's largest card-vs-CPU gradient error
    # (a sign the noise cannot flip) is held to 1e-6 + 1e-4 relative, and
    # every element to 2 lr.
    worst = phase6_readings(phase2_scene(), ieee_convolutions, devices)
    problems = worst.pop("problems")
    for r in worst.pop("worst_gradients"):
        print(f"  card vs CPU gradient {r[2]}: max err {r[0]:.3e} of its model's largest gradient, "
              f"mean err {r[1]:.3e} of its own")
    if problems:
        for problem in problems[:12]:
            print(f"  card vs CPU: {problem}")
        raise SmokeFailure(f"card vs CPU train step: {len(problems)} checks failed, first: {problems[0]}")
    print(f"train step card vs CPU (phase-2 scene, 1 x 2 obs, 288x512, strides 8/16): loss {worst['loss']:.6f} "
          f"vs {worst['ref_loss']:.6f}; {worst['grads']} gradient tensors within {worst['grad_rel_err']:.3e} of "
          f"their model's largest gradient (mean error up to {worst['grad_mean_rel_err']:.3e} of their own); "
          f"{worst['sign_clear_elements']} parameter elements with a clear gradient sign within "
          f"{worst['param_err']:.3e} after the step; running statistics within {worst['stats_err']:.3e} of their "
          "largest magnitude")
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

    def permutation(self, stream, n):
        self.draws.append(self.streams.permutation(stream, n))
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

    def permutation(self, stream, n):
        return self._next((n,))


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
        text += f"; {worst['reference_err_ratio']:.3f} times the CPU's distance from the reference step"
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


# ---- 14. phase 2 with the reference's options ---------------------------------

# 14a: B2/B3 for f32 operands at the direct-ray phase-2 shapes (the four
# launches of one step are two of each), a ragged launch of two backward
# chunks, and the fine pass's largest launch of 14c. Each output is held to
# F32_KERNEL_REL of its largest magnitude and F32_KERNEL_MEAN of it in the
# mean: B2-f32 against the plain version; B3-f32 against the plain backward
# in f64 at the kernels' ReLU pattern (each layer's output > 0 from B2-f32,
# `backbone_layer_outputs`). That pattern is held on its own against
# the f64 forward's (`relu_pattern_check`): each layer's pre-activations
# within F32_RELU_BAND of their rounding scale s = sum |x w| + |b| of f64's,
# every unit on the other side of f64's ReLU within that band of 0, and at
# most F32_RELU_FLIPS such units a million of a layer's. The kernels (3xTF32
# products, f32 sums) and the plain version (cuBLAS's f32 products) round
# each pre-activation in other ways, and where one lies within that rounding
# of 0 they take its ReLU's derivative on opposite sides: 0-6 units of a
# layer at 18,432-147,456 points, 13-60 at 1.3 M (PERF.md), moving d_encoded
# and the weight gradients by up to 1.3e-1 of their largest. The FFMA kernel
# the 3xTF32 one replaced summed in cuBLAS's order and met its pattern. The
# plain f32 version's distance and its units on the other side of the
# kernels' are printed beside.
PHASE14_SHAPES = (("background", 4608 * 4), ("player", 4608 * 32))
PHASE14_RAGGED = 70_001
# Measured on an H100 (700 W): the FFMA kernels the 3xTF32 ones replaced up
# to 4.3e-6 of an output's largest, 1.7e-6 in the mean; the 3xTF32 ones up
# to 1.3e-6, 2.1e-7 in the mean (B3-f32 against f64 at its ReLU pattern).
F32_KERNEL_REL, F32_KERNEL_MEAN = 2e-5, 5e-6
# The kernels' ReLU pattern against f64's: pre-activation errors and units
# on the other side in units of their rounding scale s (2^-16 = 256 times
# f32's unit roundoff), and units on the other side a million of a layer's,
# with a floor of F32_RELU_FLIPS_FLOOR for small launches. Measured on an
# H100 (700 W): errors up to 3.9e-7 of s, units on the other side within
# 8.4e-8 of it, 0.21 a million at most; a split that drops its small halves
# (TF32 operands alone) is off by over 16 times the band
# (tests/test_torch_port_backbone_f32.py).
F32_RELU_BAND = 2.0 ** -16
F32_RELU_FLIPS, F32_RELU_FLIPS_FLOOR = 1.0, 4
# The card's dense TF32 tensor-core rate (H100 SXM data sheet); a 3xTF32
# product costs three of its operations.
PEAK_TF32_FLOPS = 494.7e12
# 14b: the tiny tennis decoder scene with every option on; 14c: tennis.yaml
# at full width with them, at PHASE14_BATCH x 4 for PHASE14_STEPS steps: bs
# 1 x 4 peaks at 43.12 GB on an H100, nearly all of it activations that
# grow with the batch (14c prints the share and bs 2's projection).
PHASE14_DIVERGENCE = 0.1
PHASE14_CAMERA_RATE = 1e-4
PHASE14_CAMERA_MEMORY = 64
PHASE14_BATCH, PHASE14_OBSERVATIONS, PHASE14_STEPS = 1, 4, 3
# 14b's bounds, the arguments of _card_cpu_checks (as TOLERANCES_13):
# card vs CPU, and the card's step with remat vs without.
# Measured on an H100 (700 W): card vs CPU, gradients within 3.4e-4 of
# their model's largest, norms 1.6e-3, the statistics 1.5e-5; the card's
# step without remat against it, 2.6e-6, 8.0e-6 and 0. The bounds sit 2.5-8
# times above these.
TOLERANCES_14 = {
    "options": dict(loss_rtol=1e-5, stats_tol=1e-4, grad_tol=1e-3, norm_tol=4e-3, cosine=0.9999),
    "remat": dict(loss_rtol=1e-6, stats_tol=1e-6, grad_tol=2e-5, norm_tol=5e-5, cosine=0.99999),
}
# 14d: remat's memory on 13b's path and phase 1's; batches tried with remat.
REMAT_STEPS = 3
REMAT_BATCHES = (2, 3, 4)
MEMORY_LIMIT = 70e9
# 14e: a use_fine model's frames through the composer-based path.
PHASE14_FRAME_TILE = 8192


def options_config(repo, tiny):
    """configs/tennis.yaml (the tiny cut of tiny_published_config, or full
    width at the YAML's f32 with the fused backbone) with every option this
    slice ports: use_fine on every object model at the YAML's (or the
    tiny cut's coarse) fine counts, separate fine fields, the divergence
    loss, per-frame camera offsets at their own nonzero rate, remat."""
    from playableenvironments_tpu_torch.cli.common import load_yaml

    cfg = tiny_published_config(repo, "tennis") if tiny else load_yaml(os.path.join(repo, "configs", "tennis.yaml"))
    model = cfg["model"]
    for block in model["object_models"]:
        block["use_fine"] = True
        if tiny:
            block["positions_count_fine"] = block["positions_count_coarse"]
        else:
            block["nerf_model"]["use_fused_backbone"] = True
    model.update(separate_fine=True, enable_camera_parameters_offsets=True,
                 camera_parameters_memory_size=PHASE14_CAMERA_MEMORY)
    training = cfg["training"]
    training["loss_weights"]["divergence_loss_lambda"] = PHASE14_DIVERGENCE
    training.update(camera_parameters_learning_rate=PHASE14_CAMERA_RATE, remat=True)
    return cfg


def options_batch(torch, bs, obs, height, width, device):
    """phase2_batch with distinct frame indexes, so that several rows of
    the camera table take part."""
    batch = phase2_batch(torch, bs, obs, height, width, "cpu")
    frames = torch.arange(bs * obs, dtype=torch.int32).reshape(bs, obs) % PHASE14_CAMERA_MEMORY
    return dataclasses.replace(batch, global_frame_indexes=frames, video_frame_indexes=frames).to(device)


def f32_bounds(flops, bytes_):
    """The FP32 CUDA-core bound and the 3xTF32 tensor-core bound, each
    ((ms, bound_by)): operations at 67 TFLOP/s, or three TF32 operations a
    multiply-add at 494.7, against the bytes at the memory rate."""
    out = []
    for ops in (flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS):
        mem = bytes_ / PEAK_BYTES_PER_S
        out.append((max(ops, mem) * 1e3, "operations" if ops > mem else "bytes"))
    return out


def phase14_backbone_f32_kernels(fine_points, device="cuda"):
    """14a: B2/B3 for f32 operands at the direct-ray shapes, the ragged
    launch and `fine_points` (14c's fine pass, every row held): B2-f32
    against plain_backbone_fwd and, layer by layer, its ReLU pattern against
    the f64 forward's; B3-f32 twice, bit-identical, against the f64 backward
    at that pattern (and, printed, against plain_backbone_bwd with the units
    whose pattern differs); the weight images against their plain version
    bit for bit. Times of the wrapper
    calls, the image build, the kernels alone (B3's three kernels apart),
    the plain versions, the f32 torch.matmul chain (forward) and its
    autograd (backward); the FP32 and 3xTF32 bounds and the TFLOP/s against
    each."""
    import torch

    from playableenvironments_tpu_torch.ops import fused_nerf

    report = BUILD_REPORTS.get("fused_backbone_f32.cu", "")
    for entry, info in ptxas_entries(report).items():
        print(f"14a ptxas {entry}: {info}")
    rows = []
    shapes = PHASE14_SHAPES + (("ragged", PHASE14_RAGGED), ("fine", fine_points))
    for index, (name, points) in enumerate(shapes):
        cfg, packed, encoded, g_h, g_alpha = phase5_inputs(points, seed=40 + index, compute_dtype="float32",
                                                           device=device)
        f32 = {k: v.clone().requires_grad_() for k, v in packed.items()}
        pe = encoded.shape[1]
        worst, worst_mean = 0.0, 0.0
        with torch.no_grad():
            buffers = fused_nerf.backbone_f32_buffers(cfg, packed)
            plain_buffers = fused_nerf.plain_backbone_f32_buffers(cfg, {k: v.cpu() for k, v in packed.items()})
            for field, got, ref in zip(plain_buffers._fields, buffers, plain_buffers):
                if not torch.equal(got.cpu(), ref):
                    raise SmokeFailure(f"B2-f32 {name}: the card's {field} image differs from its plain version")
            h, alpha = fused_nerf.fused_backbone_fwd(cfg, packed, encoded)
            ref_h, ref_alpha = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
            outputs = [("h", h, ref_h), ("alpha", alpha, ref_alpha)]
            for key, got, ref in outputs:
                scale = ref.abs().max().item()
                err, mean = check_close(f"B2-f32 {name} {key}", got, ref, F32_KERNEL_REL * scale, 0.0,
                                        F32_KERNEL_MEAN * scale)
                worst, worst_mean = max(worst, err / scale), max(worst_mean, mean / scale)
            fwd_err = (worst, worst_mean)
            del h, alpha, ref_h, ref_alpha, outputs
            grads, d_enc = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
            again, d_enc_again = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
            if not (torch.equal(d_enc, d_enc_again) and all(torch.equal(grads[k], again[k]) for k in grads)):
                raise SmokeFailure(f"B3-f32 {name}: two launches on the same inputs differ")
            del again, d_enc_again
            ref_grads, ref_d_enc = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
            plain_worst = 0.0
            for key, got, ref in [("d_encoded", d_enc, ref_d_enc)] + [(k, grads[k], ref_grads[k]) for k in ref_grads]:
                plain_worst = max(plain_worst, ((got - ref).abs().max() / ref.abs().max()).item())
            plain_acts = fused_nerf._plain_backbone_acts(cfg, packed, encoded, lambda x: x)
            masks, pattern = fused_nerf.relu_pattern_check(
                cfg, packed, encoded, fused_nerf.backbone_layer_outputs(cfg, packed, encoded))
            flips = [int((m != (a > 0)).sum()) for m, a in zip(masks, plain_acts)]
            del ref_grads, ref_d_enc, plain_acts
            torch.cuda.empty_cache()
            flip_limit = max(F32_RELU_FLIPS_FLOOR, F32_RELU_FLIPS * points * cfg.layers_width / 1e6)
            print(f"14a {name} ({points} points): the kernels' ReLU pattern against f64's, layers 0-"
                  f"{cfg.backbone_layers_count - 1}: units on the other side {[r['flips'] for r in pattern]} "
                  f"(limit {flip_limit:.1f}), their largest |z| / s "
                  f"[{', '.join(format(r['flip_ratio'], '.3e') for r in pattern)}], pre-activation error / s "
                  f"[{', '.join(format(r['error_ratio'], '.3e') for r in pattern)}] (band {F32_RELU_BAND:.3e})")
            for layer, r in enumerate(pattern):
                if not (r["flips"] <= flip_limit and r["flip_ratio"] <= F32_RELU_BAND
                        and r["error_ratio"] <= F32_RELU_BAND):
                    raise SmokeFailure(f"B2-f32 {name} layer {layer}: ReLU pattern against f64's {r} outside "
                                       f"{flip_limit:.1f} units and {F32_RELU_BAND:.3e} of the rounding scale")
            ref_grads, ref_d_enc = fused_nerf.plain_backbone_bwd(
                cfg, {k: v.double() for k, v in packed.items()}, encoded.double(), g_h.double(), g_alpha.double(),
                masks)
            del masks
            worst, worst_mean = 0.0, 0.0
            for key, got, ref in [("d_encoded", d_enc, ref_d_enc)] + [(k, grads[k], ref_grads[k]) for k in ref_grads]:
                ref = ref.reshape(got.shape)
                scale = ref.abs().max().item()
                err, mean = check_close(f"B3-f32 {name} {key}", got.double(), ref, F32_KERNEL_REL * scale, 0.0,
                                        F32_KERNEL_MEAN * scale)
                worst, worst_mean = max(worst, err / scale), max(worst_mean, mean / scale)
            bwd_err = (worst, worst_mean)
            del grads, d_enc, ref_grads, ref_d_enc
            torch.cuda.empty_cache()
        row = {"object": name, "points": points, "fwd_max_rel_err": fwd_err[0], "fwd_mean_rel_err": fwd_err[1],
               "bwd_max_rel_err": bwd_err[0], "bwd_mean_rel_err": bwd_err[1],
               "bwd_plain_f32_max_rel_err": plain_worst, "relu_flips_vs_plain_f32": flips,
               "relu_pattern_vs_f64": pattern}
        if name != "ragged":
            reps = 3 if name == "fine" else 10
            with torch.no_grad():
                image_ms = cuda_ms(lambda: fused_nerf.backbone_f32_buffers(cfg, packed), warmup=1, reps=reps)
                ms = cuda_ms(lambda: fused_nerf.fused_backbone_fwd(cfg, packed, encoded), warmup=1, reps=reps)
                kernel_ms = cuda_ms(lambda: fused_nerf.fused_backbone_fwd(cfg, packed, encoded, buffers), warmup=1,
                                    reps=reps)
                plain_ms = cuda_ms(lambda: fused_nerf.plain_backbone_fwd(cfg, packed, encoded), warmup=1, reps=reps)
                library_ms = cuda_ms(lambda: library_backbone(torch, cfg, f32, encoded, torch.float32), warmup=1,
                                     reps=reps)
                bwd_ms = cuda_ms(lambda: fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha),
                                 warmup=1, reps=reps)
                bwd_kernel_ms = cuda_ms(lambda: fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha,
                                                                              buffers), warmup=1, reps=reps)
                breakdown = fused_nerf.backbone_f32_bwd_breakdown(cfg, packed, encoded, g_h, g_alpha, buffers)
                bwd_plain_ms = cuda_ms(lambda: fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha),
                                       warmup=1, reps=reps)
            lib_h, lib_alpha = library_backbone(torch, cfg, f32, encoded, torch.float32)
            bwd_library_ms = cuda_ms(lambda: torch.autograd.backward([lib_h, lib_alpha], [g_h, g_alpha],
                                                                     retain_graph=True), warmup=1, reps=reps)
            del lib_h, lib_alpha
            fwd_flops, fwd_bytes, bwd_flops, bwd_bytes = backbone_work(cfg, pe, points)
            (fp32_fwd, fp32_fwd_by), (tf32_fwd, tf32_fwd_by) = f32_bounds(fwd_flops, fwd_bytes)
            (fp32_bwd, fp32_bwd_by), (tf32_bwd, tf32_bwd_by) = f32_bounds(bwd_flops, bwd_bytes)
            row.update(
                ms=ms, kernel_ms=kernel_ms, image_ms=image_ms, plain_ms=plain_ms, library_ms=library_ms,
                bwd_ms=bwd_ms, bwd_kernel_ms=bwd_kernel_ms, bwd_breakdown_ms=breakdown, bwd_plain_ms=bwd_plain_ms,
                bwd_library_ms=bwd_library_ms,
                fp32_bound_ms=fp32_fwd, tf32_bound_ms=tf32_fwd, bwd_fp32_bound_ms=fp32_bwd, bwd_tf32_bound_ms=tf32_bwd,
                bound_ms=min(fp32_fwd, tf32_fwd), bound_by=tf32_fwd_by if tf32_fwd < fp32_fwd else fp32_fwd_by,
                bwd_bound_ms=min(fp32_bwd, tf32_bwd), bwd_bound_by=tf32_bwd_by if tf32_bwd < fp32_bwd else fp32_bwd_by,
                fwd_gflop=fwd_flops / 1e9, fwd_mbytes=fwd_bytes / 1e6, bwd_gflop=bwd_flops / 1e9,
                bwd_mbytes=bwd_bytes / 1e6)
            fwd_rate, bwd_rate = fwd_flops / kernel_ms / 1e9, bwd_flops / bwd_kernel_ms / 1e9
            print(f"14a B2-f32 {name} ({points} points): call {ms:.4f} ms (image build {image_ms:.4f} ms), kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, f32 torch.matmul chain {library_ms:.4f} ms; bounds "
                  f"FP32 {fp32_fwd:.4f} ms, 3xTF32 {tf32_fwd:.4f} ms ({tf32_fwd_by}); {fwd_rate:.1f} TFLOP/s = "
                  f"{fwd_rate / (PEAK_F32_FLOPS / 1e12):.2f} of the FP32 peak, "
                  f"{fwd_rate / (PEAK_TF32_FLOPS / 3e12):.2f} of the 3xTF32 one")
            print(f"14a B3-f32 {name} ({points} points): call {bwd_ms:.4f} ms, kernels {bwd_kernel_ms:.4f} ms (tile "
                  f"{breakdown['tile_ms']:.4f}, dW {breakdown['dw_ms']:.4f}, reduction {breakdown['reduce_ms']:.4f}), "
                  f"plain {bwd_plain_ms:.4f} ms, chain autograd {bwd_library_ms:.4f} ms; bounds FP32 {fp32_bwd:.4f} "
                  f"ms, 3xTF32 {tf32_bwd:.4f} ms ({tf32_bwd_by}); {bwd_rate:.1f} TFLOP/s = "
                  f"{bwd_rate / (PEAK_F32_FLOPS / 1e12):.2f} of the FP32 peak, "
                  f"{bwd_rate / (PEAK_TF32_FLOPS / 3e12):.2f} of the 3xTF32 one")
        print(f"14a {name} ({points} points): images bit for bit; B2-f32 max err {fwd_err[0]:.3e}, mean "
              f"{fwd_err[1]:.3e} (against the plain version); B3-f32 bit-identical twice, max err {bwd_err[0]:.3e}, "
              f"mean {bwd_err[1]:.3e} (against f64 at the kernels' ReLU pattern; the plain f32 version "
              f"{plain_worst:.3e}, ReLU units of layers 0-{cfg.backbone_layers_count - 1} on the other side {flips}); "
              f"of each output's largest, bounds {F32_KERNEL_REL}, {F32_KERNEL_MEAN}")
        rows.append(row)
        del encoded, g_h, g_alpha, f32, packed, buffers
        torch.cuda.empty_cache()
    return rows


def _options_step(trainer, batch, rng, remat):
    import torch

    trainer.cfg = dataclasses.replace(trainer.cfg, remat=remat)
    return _synthesis_step(torch, trainer, batch, rng)


def phase14_options_card_vs_cpu(repo, devices=("cuda", "cpu")):
    """14b: one decoder-path step of the tiny tennis scene with every
    option on (options_config), card vs CPU inside ieee_convolutions, the
    draws made once on the CPU (perturbation and the style shuffle on);
    then the same step on the card without remat, held against the card's
    step with it."""
    import torch

    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer

    cfg = options_config(repo, tiny=True)
    train_cfg = dataclasses.replace(synthesis_training_config(cfg), patch_size=TINY_PATCH, frozen_autoencoder_steps=0)
    bs, obs = TINY_BATCH
    outputs, recorded = [], RecordedStreams(15)
    for i, device in enumerate(reversed(devices)):  # the CPU first: it draws
        model = build_environment_model(cfg, device=device, seed=5)
        batch = options_batch(torch, bs, obs, *TINY_IMAGE, device)
        rng = recorded if i == 0 else ReplayedStreams(recorded.draws, device)
        with ieee_convolutions(device):
            outputs.append(_options_step(SynthesisTrainer(model, train_cfg), batch, rng, True))
    host, card = outputs
    worst = _card_cpu_checks("14b options step", card, host, train_cfg.learning_rate, **TOLERANCES_14["options"])
    model = build_environment_model(cfg, device=devices[0], seed=5)
    batch = options_batch(torch, bs, obs, *TINY_IMAGE, devices[0])
    with ieee_convolutions(devices[0]):
        loss, metrics, grads, state = _options_step(SynthesisTrainer(model, train_cfg), batch,
                                                    ReplayedStreams(recorded.draws, devices[0]), False)
    to_host = lambda tree: {k: v.cpu() for k, v in tree.items()}  # noqa: E731
    plain = (loss.cpu(), to_host(metrics), to_host(grads), to_host(state))
    remat = _card_cpu_checks("14b remat vs plain on the card", card, plain, train_cfg.learning_rate,
                             **TOLERANCES_14["remat"])
    fine = sorted({n.split(".")[1] for n in card[2] if ".object_model_fine_" in n})
    print(f"14b options step card vs CPU ({bs} x {obs} obs, {TINY_IMAGE[0]}x{TINY_IMAGE[1]}, patch {TINY_PATCH}, "
          f"use_fine with separate fields {fine}, divergence {PHASE14_DIVERGENCE}, camera offsets at "
          f"{PHASE14_CAMERA_RATE}, remat): loss {worst['loss']:.6f} vs {worst['ref_loss']:.6f}; "
          f"{_describe_checks(worst)}")
    print(f"14b the same step on the card without remat: loss {remat['ref_loss']:.6f} vs {remat['loss']:.6f} with; "
          f"{_describe_checks(remat)}")
    return {"card_vs_cpu": worst, "remat_vs_plain": remat}


def _moved(state, before, names):
    import torch

    return sum(not torch.equal(state[n], before[n]) for n in names), len(names)


def phase14_main_path(repo, batch_size=PHASE14_BATCH, steps=PHASE14_STEPS, device="cuda"):
    """14c: tennis.yaml's phase 2 at full width through
    synthesis_training_config and build_environment_model with every
    option on (options_config: use_fine with separate fields at the YAML's
    fine counts, the fused backbone at the YAML's f32, divergence, camera
    offsets, remat), random 288x512 frames: finite losses, the coarse and
    fine fields, the bender and the camera table moved, the autoencoder
    frozen, B2-f32 and B3-f32 launches a step counted from 0; the median
    step and the peak memory."""
    import statistics as stats_lib

    import torch

    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cfg = options_config(repo, tiny=False)
    model = build_environment_model(cfg, device=device, seed=0)
    train_cfg = synthesis_training_config(cfg)
    if not (train_cfg.decode_patches and train_cfg.remat and train_cfg.camera_parameters_learning_rate > 0
            and train_cfg.loss_weights.divergence > 0):
        raise SmokeFailure(f"14c: the options are not all on: {train_cfg}")
    trainer = SynthesisTrainer(model, train_cfg)
    batch = options_batch(torch, batch_size, PHASE14_OBSERVATIONS, *DECODER_IMAGE, device)
    rng = RngStreams(0, device)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # What does not grow with the batch: the weights, their copy above and
    # Adam's two moments.
    fixed = torch.cuda.memory_allocated() + 2 * sum(p.numel() * p.element_size() for p in model.parameters())
    counters = (fused_nerf.backbone_f32_fwd, fused_nerf.backbone_f32_bwd, fused_nerf.fused_backbone_fwd,
                fused_nerf.fused_backbone_bwd, fused_nerf.backbone_f32_buffers)
    for counter in counters:
        counter.launches = 0
    step_ms, losses = [], []
    for _ in range(steps):
        start = time.perf_counter()
        metrics = trainer.train_step(batch, rng)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        losses.append({k: v.item() for k, v in metrics.items()})
    launches = tuple(counter.launches for counter in counters)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise SmokeFailure(f"14c losses {losses}")
    state, params = model.state_dict(), dict(model.named_parameters())
    if not all(bool(torch.isfinite(p).all()) for p in params.values()):
        raise SmokeFailure(f"14c: a parameter is not finite after {steps} steps")
    groups = {
        "coarse_fields": [n for n in params if n.startswith("composer.object_model_") and "_fine_" not in n
                          and ".ray_bender." not in n],
        "fine_fields": [n for n in params if n.startswith("composer.object_model_fine_")],
        "benders": [n for n in params if ".ray_bender." in n],
        "camera_offsets": ["camera_offsets.storage"],
        "autoencoder": [n for n in params if n.startswith("autoencoder.")],
    }
    moved = {k: _moved(state, before, v) for k, v in groups.items()}
    if not (all(moved[k][0] >= 0.5 * moved[k][1] > 0 for k in ("coarse_fields", "fine_fields", "benders"))
            and moved["camera_offsets"] == (1, 1) and moved["autoencoder"][0] == 0):
        raise SmokeFailure(f"14c: moved (of) {moved}")
    objects = fused_launches_a_step(model.scene)
    # A step: every AdaIN object's coarse and fine pass, each NeRF's forward
    # once more in its rematerialized region's recompute, one backward each;
    # each forward builds its weight images once (the pack kernel).
    expected = (4 * objects * steps, 2 * objects * steps, 0, 0, 4 * objects * steps)
    if launches != expected:
        raise SmokeFailure(f"14c: launches (B2-f32, B3-f32, B2, B3, f32 image builds) {launches} in {steps} steps, "
                           f"expected {expected}")
    median = stats_lib.median(step_ms[1:])
    rays = sum(p * p for p in _patch_sizes(train_cfg))
    fine_points = batch_size * PHASE14_OBSERVATIONS * rays * max(
        o.positions_count_coarse + o.positions_count_fine for o in model.scene.object_models)
    print(f"14c tennis.yaml phase 2 with every option (bs {batch_size} x {PHASE14_OBSERVATIONS} obs, "
          f"{DECODER_IMAGE[0]}x{DECODER_IMAGE[1]}, patch {train_cfg.patch_size}, use_fine at the YAML's fine counts "
          f"with separate fields, f32 fused backbone, divergence {PHASE14_DIVERGENCE}, camera offsets at "
          f"{PHASE14_CAMERA_RATE}, remat): {steps} steps, B2-f32 {launches[0]} and B3-f32 {launches[1]} launches "
          f"({launches[0] // steps} and {launches[1] // steps} a step, the recompute's included; {launches[4]} image "
          f"builds), bf16 B2/B3 {launches[2]}/{launches[3]}; median step {median:.3f} ms over steps 2-{steps}; all steps ms "
          f"{[round(t, 3) for t in step_ms]}; losses {[round(m['loss'], 6) for m in losses]}; moved (of): {moved}; "
          f"the fine pass's largest launch {fine_points} points; peak memory {peak / 2**30:.3f} GiB "
          f"({peak / 1e9:.2f} GB), of which {fixed / 1e9:.2f} GB do not grow with the batch: bs "
          f"{batch_size + 1} x {PHASE14_OBSERVATIONS} projects to "
          f"{(fixed + (peak - fixed) * (batch_size + 1) / batch_size) / 1e9:.2f} GB")
    return {"batch": batch_size, "observations": PHASE14_OBSERVATIONS, "launches": launches, "step_ms": step_ms,
            "median_step_ms": median, "losses": losses, "peak_memory_bytes": peak, "fixed_memory_bytes": fixed,
            "moved": moved, "fine_launch_points": fine_points, "model": model}


def _decoder_path_peak(repo, batch_size, steps, remat, device="cuda"):
    """13b's tennis decoder path (bench.py's bf16 overrides) with `remat`
    on or off: (median step ms from step 2, peak bytes)."""
    import statistics as stats_lib

    import torch

    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cfg = published_phase2_config(repo, "tennis")
    model = build_environment_model(cfg, device=device, seed=0)
    trainer = SynthesisTrainer(model, dataclasses.replace(synthesis_training_config(cfg), remat=remat))
    batch = decoder_batch(torch, "tennis", batch_size, DECODER_OBSERVATIONS["tennis"], *DECODER_IMAGE, device)
    rng = RngStreams(0, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(steps):
        start = time.perf_counter()
        metrics = trainer.train_step(batch, rng)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        if not math.isfinite(metrics["loss"].item()):
            raise SmokeFailure(f"14d decoder path bs {batch_size} remat {remat}: loss {metrics['loss'].item()}")
    peak = torch.cuda.max_memory_allocated()
    del model, trainer, batch
    torch.cuda.empty_cache()
    return stats_lib.median(step_ms[1:]), peak


def _phase1_peak(batch_size, steps, remat, device="cuda"):
    import statistics as stats_lib

    import numpy as np
    import torch

    from playableenvironments_tpu_torch.utils.random import RngStreams

    trainer = phase1_trainer("v8", "bfloat16", device)
    trainer.cfg = dataclasses.replace(trainer.cfg, remat=remat)
    images = torch.from_numpy(np.random.default_rng(0).random((batch_size,) + DECODER_IMAGE + (3,), np.float32)).to(
        device)
    rng = RngStreams(0, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(steps):
        start = time.perf_counter()
        metrics = trainer.train_step(images, rng)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        if not all(math.isfinite(v.item()) for v in metrics.values()):
            raise SmokeFailure(f"14d phase 1 remat {remat}: metrics {metrics}")
    peak = torch.cuda.max_memory_allocated()
    del trainer, images
    torch.cuda.empty_cache()
    return stats_lib.median(step_ms[1:]), peak


def phase14_remat_memory(repo):
    """14d: remat's memory and time on 13b's tennis decoder path (options
    off) at bs 2 x 4 off and on, then the largest of REMAT_BATCHES whose
    peak with remat, projected from bs 1 and 2 and then measured, stays
    under 70 GB; phase 1 at bs 20 off and on."""
    out = {}
    for remat in (False, True):
        out[f"decoder_bs2_remat_{remat}"] = _decoder_path_peak(repo, 2, REMAT_STEPS, remat)
    bs1 = _decoder_path_peak(repo, 1, 2, True)
    per_image = out["decoder_bs2_remat_True"][1] - bs1[1]
    fits = [bs for bs in REMAT_BATCHES if bs1[1] + (bs - 1) * per_image < MEMORY_LIMIT]
    largest = max(fits) if fits else None
    if largest and largest > 2:
        out[f"decoder_bs{largest}_remat_True"] = _decoder_path_peak(repo, largest, REMAT_STEPS, True)
    measured = {bs: out[f"decoder_bs{bs}_remat_True"][1] for bs in REMAT_BATCHES if f"decoder_bs{bs}_remat_True" in out}
    under = [bs for bs, peak in measured.items() if peak < MEMORY_LIMIT]
    out["decoder_largest_batch_with_remat"] = max(under) if under else None
    for remat in (False, True):
        out[f"phase1_bs{PHASE1_BATCH}_remat_{remat}"] = _phase1_peak(PHASE1_BATCH, REMAT_STEPS, remat)
    text = "; ".join(f"{k}: median step {v[0]:.3f} ms, peak {v[1] / 1e9:.2f} GB" for k, v in out.items()
                     if isinstance(v, tuple))
    print(f"14d remat's memory: {text}; decoder path bs 1 with remat peaks at {bs1[1] / 1e9:.2f} GB, "
          f"{per_image / 1e9:.2f} GB more an image of 4 observations; the largest per-card batch under "
          f"{MEMORY_LIMIT / 1e9:.0f} GB with remat: {out['decoder_largest_batch_with_remat']} x 4 "
          f"(the published 8 x 4 projects to {(bs1[1] + 7 * per_image) / 1e9:.2f} GB)")
    out["decoder_bs1_remat_True"] = bs1
    out["projected_bs8_remat_bytes"] = bs1[1] + 7 * per_image
    return out


def phase14_frames(repo, model=None, devices=("cuda", "cpu")):
    """14e: a use_fine model's frames through render_frame_from_scene_encoding
    and decode_rendered_grids (FrameRenderer(use_fast=False)): the tiny
    options scene at 48x64 card vs CPU in full-precision convolutions, then
    `model` (14c's, at full width) at 512x288 in tiles of
    PHASE14_FRAME_TILE rays, timed, with its peak memory and B2-f32
    launches."""
    import numpy as np
    import torch

    from playableenvironments_tpu_torch.cli.common import build_environment_model
    from playableenvironments_tpu_torch.eval.creators import FrameRenderer
    from playableenvironments_tpu_torch.models.autoencoder import autoencoder_strides
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.scene.encoding import SceneEncoding

    def encoding_for(scene, device):
        generator = torch.Generator().manual_seed(16)
        objects = len(scene.object_models)
        style = scene.object_models[0].style_features
        deformation = scene.object_models[0].deformation_features
        translations = torch.zeros(1, 1, objects, 3)
        translations[..., 2:, 0] = torch.tensor([-2.0, 2.0])[: objects - 2]
        translations[..., 2:, 1] = torch.tensor([-5.0, -10.0])[: objects - 2]
        return SceneEncoding(
            torch.tensor([[[[-0.65, 0.0, 0.0]]]]), torch.tensor([[[[0.0, 18.0, 10.0]]]]), torch.full((1, 1, 1), 600.0),
            torch.zeros(1, 1, objects, 3), translations, torch.randn(1, 1, objects, style, generator=generator) * 0.1,
            torch.randn(1, 1, objects, deformation, generator=generator) * 0.1, torch.ones(1, 1, objects, dtype=torch.bool),
        ).map(lambda x: x.to(device))

    cfg = options_config(repo, tiny=True)
    frames = []
    for device in reversed(devices):
        tiny = build_environment_model(cfg, device=device, seed=5).eval()
        strides = autoencoder_strides(tiny.scene.autoencoder)
        renderer = FrameRenderer(tiny, tiny.autoencoder, TINY_IMAGE, strides, ray_tile=100, use_fast=False)
        with ieee_convolutions(device):
            frames.append(renderer.render(encoding_for(tiny.scene, device)).cpu())
    err = (frames[1] - frames[0]).abs().max().item()
    if not (frames[0].shape == (1, 1, 1) + TINY_IMAGE + (3,) and err <= FRAME_ATOL):
        raise SmokeFailure(f"14e use_fine frame {tuple(frames[0].shape)}: card vs CPU err {err:.3e}")
    out = {"small_frame_max_abs_err": err}
    if model is not None:
        model.eval()
        strides = autoencoder_strides(model.scene.autoencoder)
        renderer = FrameRenderer(model, model.autoencoder, DECODER_IMAGE, strides, ray_tile=PHASE14_FRAME_TILE,
                                 use_fast=False)
        encoding = encoding_for(model.scene, devices[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_nerf.backbone_f32_fwd.launches = 0
        times = []
        for _ in range(3):
            start = time.perf_counter()
            frame = renderer.render(encoding)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        launches = fused_nerf.backbone_f32_fwd.launches
        frame = frame.cpu().numpy()
        if not (frame.shape == (1, 1, 1) + DECODER_IMAGE + (3,) and np.isfinite(frame).all()):
            raise SmokeFailure(f"14e full frame {frame.shape} not finite")
        out.update(frame_ms=times, frame_median_ms=statistics.median(times[1:]),
                   frame_peak_memory_bytes=torch.cuda.max_memory_allocated(), frame_launches=launches)
        print(f"14e use_fine frame 48x64 card vs CPU (composer path, ray tiles of 100): max abs err {err:.3e} "
              f"(tolerance {FRAME_ATOL}); 512x288 at full width (f32 fused backbone, tiles of {PHASE14_FRAME_TILE} "
              f"rays): {[round(t, 3) for t in times]} ms, median {out['frame_median_ms']:.3f} ms after the first, "
              f"{launches} B2-f32 launches in 3 frames, peak memory {out['frame_peak_memory_bytes'] / 1e9:.2f} GB")
    return out


def phase14(repo):
    """14a-14e (module docstring). 14c runs first: its fine pass sets
    14a's largest launch; 14a then runs while the card holds nothing
    else."""
    import torch

    results = {"options_card_vs_cpu": phase14_options_card_vs_cpu(repo)}
    main = phase14_main_path(repo)
    model = main.pop("model")
    results["main_path"] = main
    results["frames"] = phase14_frames(repo, model)
    del model
    torch.cuda.empty_cache()
    results["kernels"] = phase14_backbone_f32_kernels(main["fine_launch_points"])
    results["remat_memory"] = phase14_remat_memory(repo)
    return results


# ---- 15. the consistency passes, and checkpoints through the published chain ----

# The consistency weights of 15a-15b and the samples an image of each pass.
CONSISTENCY_WEIGHTS = dict(pose_consistency=1.0, keypoint_consistency=1.0, keypoint_opacity=0.1,
                           consistency_samples=16)
# The players' dataset boxes move this much a frame (normalized l, t, r,
# b); the flow elsewhere than on a player is this small constant (d_row,
# d_col).
BOX_MOTION = (0.01, 0.005, 0.01, 0.005)
BACKGROUND_FLOW = (0.002, 0.001)
# COCO's 17 keypoints as (column, row) fractions of a player's box, and
# their confidences: four under the 0.3 gate (two ears, an eye, a wrist).
COCO_LAYOUT = ((0.5, 0.08), (0.45, 0.06), (0.55, 0.06), (0.4, 0.08), (0.6, 0.08), (0.3, 0.22), (0.7, 0.22),
               (0.2, 0.38), (0.8, 0.38), (0.15, 0.52), (0.85, 0.52), (0.38, 0.55), (0.62, 0.55), (0.36, 0.75),
               (0.64, 0.75), (0.35, 0.95), (0.65, 0.95))
COCO_CONFIDENCE = (0.9, 0.9, 0.25, 0.2, 0.2, 0.9, 0.9, 0.9, 0.9, 0.9, 0.29, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9)
CONSISTENCY_STEPS = 5
# 15b's card-vs-CPU bounds (the arguments of _card_cpu_checks), as
# TOLERANCES_13's tennis step: both sides in f32 with full-precision
# convolutions, the sums in other orders. Measured on an NVIDIA H100 80GB
# HBM3 at 700.00 W: the worst gradient element 8.1e-5 of its model's
# largest, tensor norms within 1.8e-4 relative, cosines above 0.99999, the
# losses and metrics within 2.1e-7 (1.3e-6 relative but for the keypoint
# consistency metrics of 8e-5 and 4.9e-6, 5.7e-5 and 2.5e-4 relative,
# which the check's 1e-6 floor covers), the running statistics within
# 1.5e-5 and every parameter element with a clear gradient sign within
# 6e-8. The bounds sit 6-11 times above these.
TOLERANCES_15 = dict(loss_rtol=1e-5, stats_tol=1e-4, grad_tol=5e-4, norm_tol=2e-3, cosine=0.9999)
# 15c: the chain's batches (phase 1 images; phase 2 bs x observations at
# DECODER_IMAGE; phase 3 bs at the YAML's observations) and steps.
CHAIN_PHASE1 = (4, 64, 64)
CHAIN_PHASE2 = (1, 4)
CHAIN_PHASE3_BATCH = 4
CHAIN_FRAMES = 3


@contextlib.contextmanager
def recorded_backbone_calls():
    """Within the block, a copy of the inputs of B2's and B3's calls on the
    card, the first call of each shape and direction: yields {"fwd": {key:
    (cfg, packed, encoded)}, "bwd": {key: (cfg, packed, encoded, g_h,
    g_alpha)}}, key (points, encoding width, cfg). The wrappers' launch
    counts are not kept in the block: its launches are no part of a
    counted run."""
    from playableenvironments_tpu_torch.ops import fused_nerf

    fwd, bwd = fused_nerf.fused_backbone_fwd, fused_nerf.fused_backbone_bwd
    records = {"fwd": {}, "bwd": {}}

    def keep(direction, cfg, packed, *tensors):
        key = (tensors[0].shape[0], tensors[0].shape[1], cfg)
        if tensors[0].is_cuda and key not in records[direction]:
            records[direction][key] = (cfg, {k: v.detach().clone() for k, v in packed.items()},
                                       *(t.detach().clone() for t in tensors))

    def recording_fwd(cfg, packed, encoded, buffers=None):
        keep("fwd", cfg, packed, encoded)
        return fwd(cfg, packed, encoded, buffers)

    def recording_bwd(cfg, packed, encoded, g_h, g_alpha, buffers=None):
        keep("bwd", cfg, packed, encoded, g_h, g_alpha)
        return bwd(cfg, packed, encoded, g_h, g_alpha, buffers)

    recording_fwd.launches = recording_bwd.launches = 0
    fused_nerf.fused_backbone_fwd, fused_nerf.fused_backbone_bwd = recording_fwd, recording_bwd
    try:
        yield records
    finally:
        fused_nerf.fused_backbone_fwd, fused_nerf.fused_backbone_bwd = fwd, bwd


def hold_recorded_backbone_calls(label, records):
    """B2 against plain_backbone_fwd and B3 against the f64
    plain_backbone_bwd at the kernels' own layer outputs on the inputs
    recorded_backbone_calls copied from a main path: B2 at phase 5's bounds
    (KERNEL_ATOL and the rest); every output of B3 within BF16_GRAD_BAND of
    each element's rounding scale, d_encoded also within D_ENCODED_REL_* of
    its largest magnitude. :return: one row a call: direction, points, and
    the largest and mean error (B2's absolute; B3's in units of the
    rounding scale, beside d_encoded's in units of its largest magnitude,
    for reading the weight and bias gradients' in units of theirs, and its
    largest cotangent: a launch whose cotangents are all 0 gives gradients
    of 0 on both sides)."""
    import torch

    from playableenvironments_tpu_torch.ops import fused_nerf

    rows = []
    with torch.no_grad():
        for cfg, packed, encoded in records["fwd"].values():
            if cfg.compute_dtype != "bfloat16":
                raise SmokeFailure(f"{label}: B2 called in {cfg.compute_dtype}, held here in bf16 only")
            points = encoded.shape[0]
            h, alpha = fused_nerf.fused_backbone_fwd(cfg, packed, encoded)
            ref_h, ref_alpha = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
            errs = [check_close(f"{label} B2 {points} points {name}", got, ref, KERNEL_ATOL, KERNEL_RTOL,
                                KERNEL_MEAN_ATOL) for name, got, ref in (("h", h, ref_h), ("alpha", alpha, ref_alpha))]
            rows.append({"direction": "B2", "points": points, "max_abs_err": max(e[0] for e in errs),
                         "mean_abs_err": max(e[1] for e in errs)})
            del h, alpha, ref_h, ref_alpha
        for cfg, packed, encoded, g_h, g_alpha in records["bwd"].values():
            points = encoded.shape[0]
            grads, d_enc = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
            acts = [x.double() for x in fused_nerf.backbone_layer_outputs(cfg, packed, encoded.float())]
            f64 = ({k: v.double() for k, v in packed.items()}, encoded.double(), g_h.double(), g_alpha.double())
            ref_grads, ref_d_enc = fused_nerf.plain_backbone_bwd(cfg, *f64, acts=acts)
            scales, d_enc_scale = fused_nerf.plain_backbone_bwd(cfg, *f64, acts=acts, magnitudes=True)
            del f64, acts
            cotangent = max(g_h.abs().max().item(), g_alpha.abs().max().item())
            scale = ref_d_enc.abs().max().item()
            err, mean = check_close(f"{label} B3 {points} points d_encoded (largest {scale:.3e}, largest cotangent "
                                    f"{cotangent:.3e})", d_enc.double(), ref_d_enc, D_ENCODED_REL_ATOL * scale, 0.0,
                                    D_ENCODED_REL_MEAN * scale)
            row = {"direction": "B3", "points": points, "max_abs_err": 0.0, "mean_abs_err": 0.0,
                   "d_encoded_max_rel_err": err / scale if scale > 0 else 0.0,
                   "grad_max_rel_err_of_largest": 0.0, "largest_cotangent": cotangent}
            outputs = [("d_encoded", d_enc, ref_d_enc, d_enc_scale)] + [
                (key, grads[key], ref_grads[key], scales[key]) for key in ref_grads]
            for key, got, ref, rounding in outputs:
                worst, worst_mean = fused_nerf.rounding_error_ratio(got, ref, rounding)
                largest = ref.abs().max().item()
                if not (worst <= BF16_GRAD_BAND and worst_mean <= BF16_GRAD_BAND_MEAN):
                    raise SmokeFailure(
                        f"{label} B3 {points} points {key}: off the f64 backward by up to {worst:.3e} of an "
                        f"element's rounding scale, {worst_mean:.3e} in the mean (bands {BF16_GRAD_BAND:.3e}, "
                        f"{BF16_GRAD_BAND_MEAN:.3e}; largest {largest:.3e}, largest scale "
                        f"{rounding.max().item():.3e}, largest cotangent {cotangent:.3e})")
                if largest > 0 and key != "d_encoded":
                    row["grad_max_rel_err_of_largest"] = max(
                        row["grad_max_rel_err_of_largest"],
                        (got.double() - ref.reshape(got.shape)).abs().max().item() / largest)
                row["max_abs_err"] = max(row["max_abs_err"], worst)
                row["mean_abs_err"] = max(row["mean_abs_err"], worst_mean)
            rows.append(row)
            del grads, d_enc, ref_grads, ref_d_enc, scales, d_enc_scale, outputs
    torch.cuda.empty_cache()
    print(f"{label}: B2/B3 held on the main path's own inputs, each shape once: " + "; ".join(
        f"B2 {r['points']} points, max err {r['max_abs_err']:.3e}, mean {r['mean_abs_err']:.3e}"
        if r["direction"] == "B2" else
        f"B3 {r['points']} points against f64 at its layer outputs within {r['max_abs_err']:.3e} of an "
        f"element's rounding scale (mean {r['mean_abs_err']:.3e}; weight gradients "
        f"{r['grad_max_rel_err_of_largest']:.3e} of their largest, d_encoded {r['d_encoded_max_rel_err']:.3e} of its; "
        f"largest cotangent {r['largest_cotangent']:.3e})" for r in rows))
    return rows


def consistency_batch(batch, model):
    """`batch` with its players' dataset boxes moving BOX_MOTION a frame, an
    optical flow and 17 COCO keypoints a player, made to follow the players
    on the screen: their boxes as `model`'s eval-mode scene encoding
    projects them. (In this batch a player's projection starts a fifth of
    its height above the bottom of its dataset box and reaches below it,
    so the pose pass, which draws its rays in the dataset boxes, hits a
    player with few of them at frame t.) The flow at frame t: inside a
    player's projected box, that box's displacement to frame t + 1 (0 at
    the last frame); inside its dataset box, from the dataset box's centre
    to the projected box's centre at t + 1, which carries the pose pass's
    rays onto the player; BACKGROUND_FLOW elsewhere. The keypoints sit at
    COCO_LAYOUT in the projected box with COCO_CONFIDENCE, valid where the
    dataset box is."""
    import torch

    from playableenvironments_tpu_torch.config import ObjectIds

    b, steps, cams, height, width = batch.observations.shape[:5]
    device = batch.observations.device
    frames = torch.arange(steps, device=device, dtype=torch.float32)
    moved = dataclasses.replace(batch, bounding_boxes=(
        batch.bounding_boxes + frames[:, None, None, None] * torch.tensor(BOX_MOTION, device=device)).contiguous())
    with torch.no_grad():
        _, aux = model.compute_scene_encoding(*moved.environment_model_args(), train=False)
    screen = aux["reconstructed_bounding_boxes"][..., ObjectIds(model.scene).static_objects_count:, :]
    centres = torch.stack([screen[..., 1] + screen[..., 3], screen[..., 0] + screen[..., 2]], dim=-1) / 2
    motion = torch.cat([centres[:, 1:] - centres[:, :-1], torch.zeros_like(centres[:, :1])], dim=1)
    rows = (torch.arange(height, device=device, dtype=torch.float32) / height)[:, None]
    cols = (torch.arange(width, device=device, dtype=torch.float32) / width)[None, :]
    flow = torch.empty(b, steps, cams, height, width, 2, device=device)
    flow[...] = torch.tensor(BACKGROUND_FLOW, device=device)
    layout = torch.tensor(COCO_LAYOUT, device=device)
    confidence = torch.tensor(COCO_CONFIDENCE, device=device)
    keypoints = []
    dataset = moved.bounding_boxes
    dataset_centres = torch.stack([dataset[..., 1] + dataset[..., 3], dataset[..., 0] + dataset[..., 2]], dim=-1) / 2
    onto = torch.cat([centres[:, 1:] - dataset_centres[:, :-1], torch.zeros_like(centres[:, :1])], dim=1)

    def inside(box):
        box = box[..., None, None]
        return (cols >= box[..., 0, :, :]) & (cols < box[..., 2, :, :]) & (rows >= box[..., 1, :, :]) & (
            rows < box[..., 3, :, :])

    for player in range(screen.shape[-2]):
        flow = torch.where(inside(screen[..., player, :])[..., None], motion[..., player, None, None, :], flow)
        flow = torch.where(inside(dataset[..., player, :])[..., None], onto[..., player, None, None, :], flow)
        box = screen[..., player, None, :]
        row = box[..., 1] + layout[:, 1] * (box[..., 3] - box[..., 1])
        col = box[..., 0] + layout[:, 0] * (box[..., 2] - box[..., 0])
        keypoints.append(torch.stack([row, col, confidence.expand(row.shape)], dim=-1))
    return dataclasses.replace(moved, optical_flow=flow, keypoints=torch.stack(keypoints, dim=-1).contiguous(),
                               keypoints_validity=batch.bounding_boxes_validity.clone())


def with_consistency(train_cfg, on=True):
    """`train_cfg` with CONSISTENCY_WEIGHTS, or with the three weights at 0."""
    weights = CONSISTENCY_WEIGHTS if on else {k: 0.0 for k in CONSISTENCY_WEIGHTS if k != "consistency_samples"}
    return dataclasses.replace(train_cfg, loss_weights=dataclasses.replace(train_cfg.loss_weights, **weights))


def consistency_calls(scene, batch, samples):
    """The passes' field calls a step as (pass, points): per player, two
    pose calls of B x (T-1) x C x samples rays and one keypoint call of B x
    T x C x samples, each ray at the player's coarse count."""
    from playableenvironments_tpu_torch.config import ObjectIds

    ids = ObjectIds(scene)
    b, steps, cams = batch.observations.shape[:3]
    calls = []
    for dynamic in range(ids.dynamic_objects_count):
        cfg = scene.object_models[ids.model_idx_by_object_idx(ids.static_objects_count + dynamic)]
        rays = b * cams * samples * cfg.positions_count_coarse
        calls += [("pose", (steps - 1) * rays)] * 2 + [("keypoint", steps * rays)]
    return calls


def phase15_consistency_main_path(repo, steps=CONSISTENCY_STEPS, device="cuda"):
    """15a: configs/tennis.yaml's phase 2 at full width (13b's path: bench.py's
    bf16 fused-backbone overrides, patch 64, bs 2 x 4 of 288x512 random
    frames) with the consistency passes (CONSISTENCY_WEIGHTS; the batch's
    flow and keypoints from consistency_batch) against the same path
    without them, in one process: median steps, peak memory, B2/B3
    launches a step (each pass's field call is one B2 launch; the keypoint
    pass's opacity loss reaches the alphas, so its calls add one B3 each;
    the pose pass reads its weights without gradient, so its calls add
    none) and the points the passes add; every consistency metric
    finite. Then one more step with the passes, its B2/B3 inputs recorded,
    and B2/B3 held against their plain versions on each shape of that step
    (the passes' calls among them)."""
    import statistics as stats_lib

    import torch

    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.config import ObjectIds
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cuda = torch.device(device).type == "cuda"
    cfg = published_phase2_config(repo, "tennis")
    model = build_environment_model(cfg, device=device, seed=0)
    bs, obs = DECODER_BATCH["tennis"], DECODER_OBSERVATIONS["tennis"]
    batch = consistency_batch(decoder_batch(torch, "tennis", bs, obs, *DECODER_IMAGE, device), model)
    base = synthesis_training_config(cfg)
    per_step = fused_launches_a_step(model.scene)
    players = ObjectIds(model.scene).dynamic_objects_count
    results = {}
    for label, on in (("without", False), ("with", True)):
        trainer = SynthesisTrainer(model, with_consistency(base, on))
        rng = RngStreams(0, device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        fused_nerf.fused_backbone_fwd.launches = 0
        fused_nerf.fused_backbone_bwd.launches = 0
        step_ms, metrics = [], []
        for _ in range(steps):
            start = time.perf_counter()
            out = trainer.train_step(batch, rng)
            if cuda:
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - start) * 1e3)
            metrics.append({k: v.item() for k, v in out.items()})
        launches = (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches)
        expected = (per_step + 3 * players, per_step + players) if on else (per_step, per_step)
        if cuda and launches != (expected[0] * steps, expected[1] * steps):
            raise SmokeFailure(f"15a {label} the passes: B2/B3 launches {launches} in {steps} steps, expected "
                               f"{expected} a step")
        names = sorted(k for k in metrics[0] if "consistency" in k or "keypoint_opacity" in k)
        if on and len(names) != 3 * players:
            raise SmokeFailure(f"15a: consistency metrics {names}")
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            raise SmokeFailure(f"15a {label} the passes: a metric is not finite: {metrics}")
        results[label] = {"step_ms": step_ms, "median_step_ms": stats_lib.median(step_ms[2:]),
                          "launches": launches, "launches_a_step": expected,
                          "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
                          "consistency_metrics": [{k: m[k] for k in names} for m in metrics]}
    with recorded_backbone_calls() as records:
        trainer.train_step(batch, RngStreams(1, device))
    held = hold_recorded_backbone_calls("15a", records) if cuda else []
    calls = consistency_calls(model.scene, batch, CONSISTENCY_WEIGHTS["consistency_samples"])
    wanted = {("B2", n) for _, n in calls} | {("B3", n) for kind, n in calls if kind == "keypoint"}
    if cuda and not wanted <= {(r["direction"], r["points"]) for r in held}:
        raise SmokeFailure(f"15a: the passes' launches {sorted(wanted)} were not all held: {held}")
    points = sum(n for _, n in calls)
    on, off = results["with"], results["without"]
    results.update(points_added=points, batch=bs, observations=obs, held=held)
    print(f"15a tennis decoder path with the consistency passes (bs {bs} x {obs} obs, {DECODER_IMAGE[0]}x"
          f"{DECODER_IMAGE[1]}, {CONSISTENCY_WEIGHTS}): median step {on['median_step_ms']:.3f} ms with, "
          f"{off['median_step_ms']:.3f} without, over steps 3-{steps}; peak {on['peak_memory_bytes'] / 2**30:.3f} "
          f"GiB with, {off['peak_memory_bytes'] / 2**30:.3f} without; B2/B3 launches a step {on['launches_a_step']} "
          f"with, {off['launches_a_step']} without; the passes add {points} points a step in "
          f"{3 * players} field calls; last step's metrics {on['consistency_metrics'][-1]}; all steps ms with "
          f"{[round(t, 3) for t in on['step_ms']]}, without {[round(t, 3) for t in off['step_ms']]}")
    return results


def phase15_consistency_card_vs_cpu(repo, devices=("cuda", "cpu")):
    """15b: 13a's tiny tennis decoder-path step (48x64, patch 8, strides (4,
    8), perturbation and the style shuffle off) with the consistency
    weights on and consistency_batch's flow and keypoints, on the card and
    on the CPU from the same seeded weights and the CPU's draws (the patch
    centre, the pose pass's box draws, the keypoint fractions), inside
    ieee_convolutions, at TOLERANCES_15."""
    import torch

    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer

    cfg = tiny_published_config(repo, "tennis")
    train_cfg = with_consistency(dataclasses.replace(
        synthesis_training_config(cfg), patch_size=TINY_PATCH, perturb=False, shuffle_style=False,
        frozen_autoencoder_steps=0))
    bs, obs = TINY_BATCH
    outputs, recorded = [], RecordedStreams(15)
    for i, device in enumerate(reversed(devices)):  # the CPU first: it draws
        model = build_environment_model(cfg, device=device, seed=5)
        batch = consistency_batch(decoder_batch(torch, "tennis", bs, obs, *TINY_IMAGE, device), model)
        rng = recorded if i == 0 else ReplayedStreams(recorded.draws, device)
        with ieee_convolutions(device):
            outputs.append(_synthesis_step(torch, SynthesisTrainer(model, train_cfg), batch, rng))
    host, card = outputs
    names = sorted(k for k in host[1] if "consistency" in k or "keypoint_opacity" in k)
    values = {k: host[1][k].item() for k in names}
    if len(names) != 6 or not all(v > 0 for v in values.values()):
        raise SmokeFailure(f"15b: the consistency metrics {values} (each player's three, each above 0)")
    worst = _card_cpu_checks("15b tennis consistency step", card, host, train_cfg.learning_rate, **TOLERANCES_15)
    worst["consistency_metrics"] = values
    worst["card_consistency_metrics"] = {k: card[1][k].item() for k in names}
    print(f"15b tennis decoder step with the consistency passes card vs CPU ({bs} x {obs} obs, {TINY_IMAGE[0]}x"
          f"{TINY_IMAGE[1]}, patch {TINY_PATCH}): loss {worst['loss']:.6f} vs {worst['ref_loss']:.6f}; metrics "
          f"CPU {values}, card {worst['card_consistency_metrics']}; {_describe_checks(worst)}")
    return worst


def _same_state(label, got, ref):
    """Raises unless the two flat states (checkpointing.flat_state's form)
    are equal entry for entry, tensors bit for bit. :return: the number of
    tensors compared."""
    import torch

    from playableenvironments_tpu_torch.train.checkpointing import state_difference

    difference = state_difference(got, ref)
    if difference is not None:
        raise SmokeFailure(f"{label}: {difference}")
    return sum(torch.is_tensor(v) for v in ref.values())


def copy_trainer_state(source, target):
    """The phase-2 trainer `source`'s model and Adam state copied into
    `target` in memory (not through a checkpoint)."""
    import copy

    target.model.load_state_dict(source.model.state_dict())
    target.optimizer.optimizer.load_state_dict(copy.deepcopy(source.optimizer.optimizer.state_dict()))
    target.optimizer.step_count = source.optimizer.step_count


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms and cuDNN's deterministic
    algorithms inside the `with` (an operation without a deterministic
    implementation raises), the previous settings after it. A phase-2
    decoder-path step is then bit-reproducible on the card: two trainers in
    one state take the same step to the bit."""
    import torch

    enabled, warn_only = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    cudnn = torch.backends.cudnn
    torch.use_deterministic_algorithms(True)
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                         allow_tf32=cudnn.allow_tf32):
            yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


def max_parameter_difference(a, b):
    """The largest element-wise difference between two modules' parameters."""
    return max((pa.detach() - pb.detach()).abs().max().item()
               for (_, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()))


def _timed(fn, device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - start) * 1e3


def phase15_chain(repo, directory, device="cuda"):
    """15c: the published chain phase 1 -> phase 2 -> phase 3 -> play through
    the port's checkpoints, in `directory`, on tennis.yaml at full width:
    phase 1 (its autoencoder, CHAIN_PHASE1 images, 2 steps, saved); phase 2
    (13b's decoder path at CHAIN_PHASE2, the phase-1 autoencoder grafted and
    held to the checkpoint bit for bit, 2 steps, saved after steps 0-2 with
    keep=2 and the prune checked); its restore into a fresh trainer (every
    parameter, buffer, Adam moment, rate group and step bit for bit); phase
    3 (restore_params of the phase-2 checkpoint into a fresh environment
    model, 2 fused G+D steps on its encodings, saved and restored:
    centroids, MI matrices and both optimizers bit for bit); play (an
    InteractiveSession of the restored phase-2 and phase-3 models renders
    CHAIN_FRAMES frames, held against the in-memory models' at FRAME_ATOL);
    then one resumed phase-2 step with deterministic algorithms against the
    uninterrupted trainer's same step (largest parameter difference: 0
    where the same step of an in-memory copy of that trainer is 0, else
    within it; both printed), the copy's B2/B3 inputs recorded and held
    against the plain versions. Save and restore times and bytes of each
    phase, B1/B2/B3/B4/B5 launches of the chain."""
    import numpy as np
    import torch

    from playableenvironments_tpu_torch.cli.common import (
        autoencoder_training_config, build_environment_model, playable_training_config, synthesis_training_config,
    )
    from playableenvironments_tpu_torch.cli.play import InteractiveSession
    from playableenvironments_tpu_torch.config import scene_from_dict
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.ops import fused_rollout as fr
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train import checkpointing as ckpt
    from playableenvironments_tpu_torch.train.trainer_autoencoder import AutoencoderTrainer
    from playableenvironments_tpu_torch.train.trainer_playable import PlayableLossWeights, PlayableTrainer
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cuda = torch.device(device).type == "cuda"
    cfg = published_phase2_config(repo, "tennis")
    results, io = {}, {}

    def save(name, trainer, **kwargs):
        path, ms = _timed(lambda: ckpt.save_checkpoint(os.path.join(directory, name), trainer, **kwargs), device)
        io.setdefault(name, {}).update(save_ms=ms, bytes=os.path.getsize(os.path.join(path, ckpt.STATE_FILE)))
        return path

    def restore(name, fn, key="restore_ms"):
        out, ms = _timed(fn, device)
        io[name][key] = ms
        return out

    # Phase 1.
    scene = scene_from_dict(cfg["model"], cfg.get("playable_model"))
    phase1 = AutoencoderTrainer(scene.autoencoder, autoencoder_training_config(cfg), device=device, seed=11)
    images = torch.from_numpy(np.random.default_rng(3).random(CHAIN_PHASE1 + (3,), np.float32)).to(device)
    for _ in range(2):
        phase1.train_step(images, RngStreams(1, device))
    phase1_path = save("phase1", phase1)

    # Phase 2: graft, two steps, saves after steps 0, 1 and 2 with keep=2.
    bs, obs = CHAIN_PHASE2
    batch = decoder_batch(torch, "tennis", bs, obs, *DECODER_IMAGE, device)
    train_cfg = synthesis_training_config(cfg)

    def phase2_trainer(seed):
        trainer = SynthesisTrainer(build_environment_model(cfg, device=device, seed=seed), train_cfg)
        restore("phase1", lambda: ckpt.graft_autoencoder(phase1_path, trainer.model), "graft_ms")
        return trainer

    uninterrupted = [phase2_trainer(0), phase2_trainer(0)]
    grafted = _same_state("15c graft", {(k,): v for k, v in uninterrupted[0].model.autoencoder.state_dict().items()},
                          {(k,): v for k, v in phase1.model.state_dict().items()})
    fused_nerf.fused_backbone_fwd.launches = 0
    fused_nerf.fused_backbone_bwd.launches = 0
    phase2_dir = os.path.join(directory, "phase2")
    save("phase2", uninterrupted[0], keep=2)
    for step in range(2):
        for trainer in uninterrupted:
            trainer.train_step(batch, RngStreams(10 + step, device))
        phase2_path = save("phase2", uninterrupted[0], keep=2)
    kept = sorted(os.listdir(phase2_dir))
    if kept != ["checkpoint_1", "checkpoint_2"] or ckpt.latest_checkpoint_any(directory, phase2_dir) != phase2_path:
        raise SmokeFailure(f"15c: keep=2 left {kept} in {phase2_dir}")
    phase2_launches = (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches)
    per_step = fused_launches_a_step(scene)
    if cuda and phase2_launches != (4 * per_step, 4 * per_step):
        raise SmokeFailure(f"15c phase 2: B2/B3 launches {phase2_launches} in 4 steps (2 trainers), expected "
                           f"{per_step} each a step")
    resumed = SynthesisTrainer(build_environment_model(cfg, device=device, seed=9), train_cfg)
    restore("phase2", lambda: ckpt.restore_checkpoint(phase2_path, resumed))
    tensors = _same_state("15c phase-2 restore", ckpt.flat_state(resumed), ckpt.flat_state(uninterrupted[0]))
    results["phase2"] = {"grafted_tensors": grafted, "restored_tensors": tensors, "kept": kept,
                         "launches": phase2_launches}
    print(f"15c phase 1 -> phase 2: the phase-1 autoencoder ({grafted} tensors) grafted bit for bit; 2 steps at bs "
          f"{bs} x {obs} obs (B2 {phase2_launches[0]}, B3 {phase2_launches[1]} launches over two trainers); keep=2 "
          f"left {kept}; restored {tensors} tensors and values bit for bit")

    # Phase 3 on the phase-2 checkpoint's model.
    environment = ckpt.restore_params(phase2_path, build_environment_model(cfg, device=device, seed=8))
    play_cfg = playable_training_config(cfg)
    play_cfg = dataclasses.replace(play_cfg, ground_truth_observations_start=PHASE3_GT,
                                   loss_weights=dataclasses.replace(play_cfg.loss_weights, gan=0.1, acmv=0.1))

    def phase3_trainer_of(seed, env):
        model = PlayableEnvironmentModel(scene, with_discriminators=True, device=device, seed=seed)
        return PlayableTrainer(model, play_cfg, environment_model=env)

    phase3 = phase3_trainer_of(2, environment)
    phase3_batch = decoder_batch(torch, "tennis", CHAIN_PHASE3_BATCH, play_cfg.observations_count, *DECODER_IMAGE,
                                 device)
    encoding = phase3.encode_batch(phase3_batch)
    phase3.init_state_from_encoding(encoding, seed=0)
    fr.fused_rollout_fwd.launches = 0
    fr.fused_rollout_bwd.launches = 0
    for step in range(2):
        metrics = phase3.fused_step(encoding, RngStreams(30 + step, device))
        if not all(math.isfinite(v.item()) for v in metrics.values()):
            raise SmokeFailure(f"15c phase 3: metrics {metrics}")
    phase3_launches = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
    if cuda and not (phase3_launches[0] >= 2 and phase3_launches[1] >= 2 and phase3_launches[0] % 2 == 0
                     and phase3_launches[1] % 2 == 0):
        raise SmokeFailure(f"15c phase 3: B4/B5 launches {phase3_launches} in 2 steps")
    phase3_path = save("phase3", phase3)
    restored3 = phase3_trainer_of(4, None)
    restore("phase3", lambda: ckpt.restore_checkpoint(phase3_path, restored3))
    saved3 = ckpt.flat_state(phase3)
    tensors3 = _same_state("15c phase-3 restore", ckpt.flat_state(restored3), saved3)
    if not any(p[0] == "discriminator_optimizer" for p in saved3) or not any(p[0] == "centroids" for p in saved3):
        raise SmokeFailure("15c phase 3: the state lacks the discriminator's optimizer or the centroids")
    results["phase3"] = {"launches": phase3_launches, "restored_tensors": tensors3}
    print(f"15c phase 2 -> phase 3: restore_params of the phase-2 checkpoint, 2 fused G+D steps on its encoding "
          f"of bs {CHAIN_PHASE3_BATCH} x {play_cfg.observations_count} (B4 {phase3_launches[0]}, B5 "
          f"{phase3_launches[1]} launches); saved and restored {tensors3} tensors and values bit for bit (both "
          "optimizers, centroids, MI matrices)")

    # Play from the restored models against the in-memory ones.
    played = build_environment_model(cfg, device=device, seed=6)
    restore("phase2", lambda: ckpt.restore_params(phase2_path, played), "restore_params_ms")
    playable = PlayableEnvironmentModel(scene, with_discriminators=True, device=device, seed=7)
    ckpt.restore_params(phase3_path, playable)
    sessions = []
    for env, anim in ((played, playable), (uninterrupted[0].model, phase3.playable_model)):
        sessions.append(InteractiveSession(scene, env.composer, env.autoencoder, anim.eval(), IMAGE_SIZE, STRIDES,
                                           FOCAL_LENGTH_MULTIPLIER))
    fused_nerf.fused_adain_nerf.launches = 0
    frames = [[], []]
    for i in range(CHAIN_FRAMES):
        for session, out in zip(sessions, frames):
            out.append(session.start(tennis_encoding(torch, device)) if i == 0
                       else session.step(list(ACTIONS[i])))
    play_launches = fused_nerf.fused_adain_nerf.launches
    frame_err = max(float(np.abs(a - b).max()) for a, b in zip(*frames))
    if not all(np.isfinite(f).all() and f.shape == (IMAGE_SIZE[0], IMAGE_SIZE[1], 3) for f in frames[0]):
        raise SmokeFailure("15c play: a frame is not finite or misshapen")
    if not frame_err <= FRAME_ATOL or (cuda and play_launches != 2 * CHAIN_FRAMES):
        raise SmokeFailure(f"15c play: frames {frame_err:.3e} from the in-memory models' (tolerance {FRAME_ATOL}), "
                           f"{play_launches} B1 launches for {2 * CHAIN_FRAMES} frames")
    results["play"] = {"launches": play_launches, "frame_max_abs_err": frame_err}
    results["io"] = io
    print(f"15c play: {CHAIN_FRAMES} frames {IMAGE_SIZE[1]}x{IMAGE_SIZE[0]} from the restored phase-2 and phase-3 "
          f"models within {frame_err:.3e} of the in-memory models' (tolerance {FRAME_ATOL}), {play_launches} B1 "
          "launches; checkpoints " + "; ".join(
              f"{name} {v['bytes'] / 2**20:.1f} MiB, " + ", ".join(f"{k[:-3]} {ms:.1f} ms" for k, ms in v.items()
                                                                 if k.endswith("_ms"))
              for name, v in io.items()))

    # One step after the restore against the same step uninterrupted and
    # the same step of an in-memory copy of the uninterrupted trainer (the
    # spread of one step), with deterministic algorithms; the copy's step
    # records its B2/B3 inputs, held below.
    copy_trainer_state(uninterrupted[0], uninterrupted[1])
    _same_state("15c in-memory copy", ckpt.flat_state(uninterrupted[1]), ckpt.flat_state(uninterrupted[0]))
    with deterministic_algorithms():
        uninterrupted[0].train_step(batch, RngStreams(20, device))
        resumed.train_step(batch, RngStreams(20, device))
        with recorded_backbone_calls() as records:
            uninterrupted[1].train_step(batch, RngStreams(20, device))
    spread = max_parameter_difference(uninterrupted[0].model, uninterrupted[1].model)
    resumed_diff = max_parameter_difference(resumed.model, uninterrupted[0].model)
    if not (resumed_diff == 0.0 if spread == 0.0 else resumed_diff <= spread):
        raise SmokeFailure(f"15c: the resumed step is {resumed_diff:.3e} from the uninterrupted one, the same "
                           f"step of an in-memory copy {spread:.3e}")
    results["phase2"].update(resumed_max_parameter_difference=resumed_diff, one_step_spread=spread)
    print(f"15c resumed phase-2 step (deterministic algorithms): largest parameter difference {resumed_diff:.3e} "
          f"from the uninterrupted step; the same step of an in-memory copy of the uninterrupted trainer "
          f"{spread:.3e} from it")
    results["phase2"]["held"] = hold_recorded_backbone_calls("15c phase 2", records) if cuda else []
    return results


def phase15(repo):
    """15a-15c (module docstring); 15c in a temporary directory it removes."""
    import shutil
    import tempfile

    import torch

    results = {"consistency_card_vs_cpu": phase15_consistency_card_vs_cpu(repo),
               "consistency": phase15_consistency_main_path(repo)}
    torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="chip_smoke_chain_")
    try:
        results["chain"] = phase15_chain(repo, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return results


# ---- phase 16: the training, play and import CLIs ------------------------------

# configs/tennis.yaml as the CLIs read it, with these changes (PERF.md §4):
# data_root at phase 11's dataset (288x512, 2 players; train 2 x 40 frames,
# test 2 x 12), logging under the run's directory, the fused backbone on
# (the YAML leaves it off, its default, and the training path reaches B2/B3
# only through it; the YAML's f32 compute dtype then takes B2-f32/B3-f32),
# and the depths and cadences cut below. Phase 1 reads single frames
# (training.batching.observations_count 1), so that its batch of 20 windows
# is 20 images, the published phase-1 batch (the JAX CLI flattens windows x
# observations).
PHASE16_AE = dict(max_steps=3, save_freq=2, quick_save_freq=1, eval_freq=2, log_interval_steps=1)
PHASE16_PHASE2 = dict(max_steps=3, save_freq=2, quick_save_freq=1, eval_freq=2, log_interval_steps=1)
PHASE16_PHASE2_BATCH = 2  # windows of 4 observations; the published 8 x 4 does not fit one card (PERF.md §5)
PHASE16_PHASE3 = dict(max_steps=5, steps_per_call=2, save_freq=4, quick_save_freq=100, eval_freq=2,
                      log_interval_steps=1)
PHASE16_SCRIPT = "0,1,2,3"


def phase16_base(repo):
    """configs/tennis.yaml, read as the CLIs read it."""
    from playableenvironments_tpu_torch.cli.common import load_yaml

    return load_yaml(os.path.join(repo, "configs", "tennis.yaml"))


def phase16_config(repo, directory, name, data_root, **sections):
    """Write `<directory>/<name>.yaml`: configs/tennis.yaml with phase 16's
    changes (above) and `sections`' keys over its sections. :return: the path."""
    import yaml

    cfg = phase16_base(repo)
    cfg["data"]["data_root"] = data_root
    cfg["logging"] = {"run_name": name, "output_root": os.path.join(directory, "results"),
                      "checkpoints_root": os.path.join(directory, "checkpoints")}
    for block in cfg["model"]["object_models"]:
        block.setdefault("nerf_model", {})["use_fused_backbone"] = True
    for section, values in sections.items():
        target = cfg
        for key in section.split("."):
            target = target.setdefault(key, {})
        target.update(values)
    path = os.path.join(directory, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_cli(module, *args):
    """A CLI's main() in this process with sys.argv set, as a user's command
    line would: (its return value, its wall seconds, the card's peak bytes)."""
    import importlib

    import torch

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    argv, sys.argv = sys.argv, [module] + [str(a) for a in args]
    start = time.perf_counter()
    try:
        out = importlib.import_module(module).main()
    finally:
        sys.argv = argv
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - start, torch.cuda.max_memory_allocated() if cuda else 0


def phase16_cli(repo, directory, device="cuda"):
    """16a-16f (module docstring) in `directory`. Each CLI's wall time split
    into startup, steps, saves and evaluation (its timing JSON), its peak
    memory and its B1-B5 launches."""
    import numpy as np
    import torch

    from playableenvironments_tpu_torch.cli.common import (
        build_dataset, build_environment_model, load_yaml, with_batching_overrides,
    )
    from playableenvironments_tpu_torch.cli.play import InteractiveSession
    from playableenvironments_tpu_torch.config import scene_from_dict
    from playableenvironments_tpu_torch.models.autoencoder import autoencoder_strides
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.ops import fused_rollout as fr
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train import checkpointing as ckpt

    sys.path.insert(0, os.path.join(repo, "tests"))
    import torch_port_reference_layout as layout

    data_root = os.path.join(directory, "data")
    write_tennis_dataset(data_root)
    checkpoints = os.path.join(directory, "checkpoints")
    results, clis = {}, {}

    def record(label, name, seconds, peak, timing_dir):
        with open(os.path.join(timing_dir, f"timing_{name}.json")) as f:
            timing = json.load(f)
        clis[label] = {"wall_s": seconds, "peak_bytes": peak, **timing}
        split = ", ".join(f"{k} {v:.2f} s" for k, v in timing["seconds"].items())
        launches = {k: v for k, v in timing["launches"].items() if v}
        each = ", ".join(f"{v:.3f}" for v in timing["step_seconds"])
        print(f"16 {label}: {seconds:.2f} s ({split}; each steps section [{each}] s), peak {peak / 1e9:.2f} GB, "
              f"launches {launches}")

    # ---- 16a. phase 1 ---------------------------------------------------------
    ae_config = phase16_config(repo, directory, "phase1", data_root, autoencoder_training=PHASE16_AE,
                               **{"training.batching": {"observations_count": 1}})
    _, seconds, peak = run_cli("playableenvironments_tpu_torch.cli.train_autoencoder", "--config", ae_config,
                               "--device", device)
    record("train_autoencoder", "train_autoencoder", seconds, peak, os.path.join(directory, "results", "phase1"))
    ae_dir = os.path.join(checkpoints, "phase1")
    kept = sorted(os.listdir(ae_dir))
    quick = sorted(os.listdir(os.path.join(ae_dir, "quick")))
    grid = os.path.join(directory, "results", "phase1", "images", "00000002_autoencoder_reconstruction.png")
    if kept != ["checkpoint_2", "checkpoint_3", "quick"] or quick != ["checkpoint_1"] or not os.path.isfile(grid):
        raise SmokeFailure(f"16a: checkpoints {kept}, quick {quick}, evaluator grid {os.path.isfile(grid)}")
    ae_path = ckpt.latest_checkpoint(ae_dir)

    # ---- 16b. phase 2 as a user runs it (PyTorch's default algorithms) -------
    phase2 = dict(PHASE16_PHASE2)
    sections = {"training": phase2, "training.batching": {"batch_size": PHASE16_PHASE2_BATCH},
                "model.autoencoder": {"weights_filename": ae_path}}
    p2_config = phase16_config(repo, directory, "phase2", data_root, **sections)
    _, seconds, peak = run_cli("playableenvironments_tpu_torch.cli.train", "--config", p2_config, "--device", device)
    record("train", "train", seconds, peak, os.path.join(directory, "results", "phase2"))
    p2_path = ckpt.latest_checkpoint(os.path.join(checkpoints, "phase2"))
    if sorted(os.listdir(os.path.join(checkpoints, "phase2"))) != ["checkpoint_2", "checkpoint_3", "quick"]:
        raise SmokeFailure(f"16b: checkpoints {sorted(os.listdir(os.path.join(checkpoints, 'phase2')))}")

    # ---- 16c. a run stopped at step 3 and resumed to 4; the uninterrupted run
    # Bit for bit needs deterministic algorithms (scripts/step_determinism.py),
    # so all three take their steps with them, and 16b's timed run without.
    p2_dir = os.path.join(checkpoints, "phase2_resumed")
    resumed_config = phase16_config(repo, directory, "phase2_resumed", data_root, **sections)
    whole_config = phase16_config(repo, directory, "phase2_whole", data_root, **{
        **sections, "training": {**phase2, "max_steps": 4}})
    with deterministic_algorithms():
        _, seconds, peak = run_cli("playableenvironments_tpu_torch.cli.train", "--config", resumed_config,
                                   "--device", device)
        record("train_deterministic", "train", seconds, peak, os.path.join(directory, "results", "phase2_resumed"))
        stopped = ckpt.latest_checkpoint(p2_dir)
        _, seconds, peak = run_cli("playableenvironments_tpu_torch.cli.train", "--config", resumed_config,
                                   "--max_steps", 4, "--device", device)
        record("train_resumed", "train", seconds, peak, os.path.join(directory, "results", "phase2_resumed"))
        _, seconds, peak = run_cli("playableenvironments_tpu_torch.cli.train", "--config", whole_config,
                                   "--device", device)
        record("train_uninterrupted", "train", seconds, peak, os.path.join(directory, "results", "phase2_whole"))
    with open(os.path.join(directory, "results", "phase2_resumed", "log.txt")) as f:
        log = f.read()
    if f"resumed from {stopped} at step 3" not in log or sorted(os.listdir(p2_dir)) != [
            "checkpoint_2", "checkpoint_3", "checkpoint_4", "quick"]:
        raise SmokeFailure(f"16c: the rerun did not resume from {stopped} and save at step 4 "
                           f"({sorted(os.listdir(p2_dir))})")
    resumed = ckpt.saved_flat_state(os.path.join(p2_dir, "checkpoint_4"))
    whole = ckpt.saved_flat_state(os.path.join(checkpoints, "phase2_whole", "checkpoint_4"))
    difference = ckpt.state_difference(resumed, whole)
    if difference is not None:
        raise SmokeFailure(f"16c: the resumed run's checkpoint_4 differs from the uninterrupted run's: {difference}")
    tensors = sum(torch.is_tensor(v) for v in whole.values())
    # The graft: 16a's autoencoder in the phase-2 model, its parameters held
    # at rate 0 (frozen_autoencoder_steps) and its encoder unused, so bit
    # for bit 16a's after the steps; the decoder's running statistics move.
    saved_ae = ckpt.saved_flat_state(ae_path)
    grafted = {k[1:]: v for k, v in ckpt.saved_flat_state(p2_path).items() if k[0] == "model"}
    same, moved = 0, 0
    for key, value in saved_ae.items():
        if key[0] != "model":
            continue
        name = ("autoencoder." + key[1],)
        if "running" in key[1] and key[1].startswith("decoder."):
            moved += int(not torch.equal(grafted[name], value))
        elif not torch.equal(grafted[name], value):
            raise SmokeFailure(f"16b: the phase-2 checkpoint's autoencoder {key[1]} is not 16a's")
        else:
            same += 1
    evaluated = os.path.isfile(os.path.join(directory, "results", "phase2", "images", "00000002_eval_render.png"))
    if not moved or not evaluated:
        raise SmokeFailure(f"16b: {moved} decoder running statistics moved, evaluator grid {evaluated}")
    results["phase2"] = {"resumed_tensors_equal": tensors, "autoencoder_tensors_equal": same,
                         "decoder_statistics_moved": moved}
    print(f"16b/16c phase 2: 16a's autoencoder grafted ({same} tensors bit for bit, {moved} decoder running "
          f"statistics moved); with deterministic algorithms a run stopped at step 3 resumed from "
          f"{os.path.basename(stopped)}, one step; its checkpoint_4 equal to the uninterrupted 4-step run's, "
          f"{tensors} tensors bit for bit")

    # ---- 16d. phase 3, twice (the second reloads the encoding cache) ----------
    p3_config = phase16_config(repo, directory, "phase3", data_root, playable_model_training=PHASE16_PHASE3)
    cfg = load_yaml(p3_config)
    _, seconds, peak = run_cli("playableenvironments_tpu_torch.cli.train_playable", "--config", p3_config,
                               "--environment_checkpoint", p2_path, "--device", device)
    record("train_playable", "train_playable", seconds, peak, os.path.join(directory, "results", "phase3"))
    p3_dir = os.path.join(checkpoints, "phase3", "playable")
    p3_path = ckpt.latest_checkpoint(p3_dir)
    steps = ckpt.checkpoint_step(p3_path)
    cache = os.path.join(p3_dir, "encoding_cache.npz")
    evals = sorted(os.listdir(os.path.join(directory, "results", "phase3", "playable_eval")))
    if steps != 6 or not os.path.isfile(cache) or evals != ["step_2", "step_4", "step_6"]:
        raise SmokeFailure(f"16d: final step {steps} (blocks of 2 carry 5 to 6), cache {os.path.isfile(cache)}, "
                           f"evaluations {evals}")
    _, seconds, peak = run_cli("playableenvironments_tpu_torch.cli.train_playable", "--config", p3_config,
                               "--environment_checkpoint", p2_path, "--device", device)
    record("train_playable_rerun", "train_playable", seconds, peak, os.path.join(directory, "results", "phase3"))
    with open(os.path.join(directory, "results", "phase3", "log.txt")) as f:
        log = f.read()
    if f"loaded encoding cache from {cache}" not in log:
        raise SmokeFailure("16d: the second run did not reload the encoding cache")
    print(f"16d phase 3: blocks of {PHASE16_PHASE3['steps_per_call']} to step {steps} (max_steps "
          f"{PHASE16_PHASE3['max_steps']}), evaluations {evals}; the encoding cache written, reloaded by a second run")

    # B4 at the evaluator's rollout_single shape, against its plain version.
    scene = scene_from_dict(cfg["model"], cfg.get("playable_model"))
    playable = ckpt.restore_params(p3_path, PlayableEnvironmentModel(scene, device=device))
    frames_t = int(cfg["playable_model_training"].get("eval_action_video_frames", 8))
    animation = playable.animation_model_0
    anim_cfg = scene.animation_models[0]
    generator = torch.Generator().manual_seed(16)
    state = [torch.randn(1, 1, w, generator=generator).repeat(1, frames_t, 1).to(device)
             for w in (3, 3, anim_cfg.style_features, anim_cfg.deformation_features)]
    actions = torch.nn.functional.one_hot(torch.full((1, frames_t - 1), 2), anim_cfg.actions_count).float().to(device)
    variations = torch.zeros(1, frames_t - 1, anim_cfg.action_space_dimension, device=device)
    packed = fr.pack_dynamics_params(animation.dynamics_network)
    with torch.no_grad():
        got = fr.fused_rollout_fwd(animation.rollout_cfg, packed, *state, actions, variations, 1, False)[0]
        ref = fr.plain_rollout_fwd(animation.rollout_cfg, packed, *state, actions, variations, 1, False)[0]
    b4_err = max(rel_close(f"16d B4 at rollout_single's shape {k}", g, r)[0]
                 for k, g, r in zip(("rot", "trans", "style", "deform"), got, ref))
    results["b4_rollout_single"] = {"batch": 1, "observations": frames_t, "max_rel_err": b4_err}

    # ---- 16e. play from the CLI checkpoints -----------------------------------
    grouped = fused_nerf.fused_adain_nerf_group
    captured = []

    def capture(cfg_nerf, items):
        outs = grouped(cfg_nerf, items)
        if not captured:
            captured.append((cfg_nerf, items, outs))
        return outs

    fused_nerf.fused_adain_nerf_group = capture
    try:
        frames, seconds, peak = run_cli(
            "playableenvironments_tpu_torch.cli.play", "--config", p3_config, "--environment_checkpoint", p2_path,
            "--playable_checkpoint", p3_path, "--script", PHASE16_SCRIPT, "--output", os.path.join(directory, "play"),
            "--device", device)
    finally:
        fused_nerf.fused_adain_nerf_group = grouped
    record("play", "play", seconds, peak, os.path.join(directory, "play"))
    written = sorted(os.listdir(os.path.join(directory, "play")))
    pngs = sorted(os.listdir(os.path.join(directory, "play", "frames")))
    expected = len(PHASE16_SCRIPT.split(",")) + 1
    if len(frames) != expected or len(pngs) != expected or "sequence.gif" not in written:
        raise SmokeFailure(f"16e: {len(frames)} frames, {len(pngs)} PNGs, {written}")
    for frame in frames:
        if frame.shape != (IMAGE_SIZE[0], IMAGE_SIZE[1], 3) or not np.isfinite(frame).all():
            raise SmokeFailure(f"16e: a frame of shape {frame.shape} or not finite")
    env = ckpt.restore_params(p2_path, build_environment_model(cfg, device=device, seed=5))
    memory_playable = ckpt.restore_params(p3_path, PlayableEnvironmentModel(scene, device=device, seed=6))
    eval_batching = cfg.get("evaluation", {}).get("batching", {})
    test = build_dataset(with_batching_overrides(cfg, **{**eval_batching, "observations_count": 1}), "test")
    session = InteractiveSession(scene, env.composer, env.autoencoder, memory_playable.eval(), IMAGE_SIZE,
                                 autoencoder_strides(scene.autoencoder), env.focal_length_multiplier,
                                 environment_model=env)
    memory = [session.initialize(next(test.iterate_batches(1, shuffle=False)))]
    memory += [session.step([int(a)] * session.object_ids.dynamic_objects_count) for a in PHASE16_SCRIPT.split(",")]
    if not all(np.array_equal(a, b) for a, b in zip(frames, memory)):
        raise SmokeFailure("16e: the play CLI's frames differ from an in-memory session of the same restored models "
                           f"(max {max(float(np.abs(a - b).max()) for a, b in zip(frames, memory)):.3e})")
    cfg_nerf, items, outs = captured[0]
    b1_rows = []
    with torch.no_grad():
        for index, (item, (feats, alpha)) in enumerate(zip(items, outs)):
            args = (item.encoded, item.scale0, item.bias0, item.scale1, item.bias1)
            refs = fused_nerf.plain_adain_nerf(cfg_nerf, item.weights.packed, *args, item.samples_per_ray)
            for name, got_out, ref_out in (("features", feats, refs[0]), ("alpha", alpha, refs[1])):
                scale = max(1.0, ref_out.abs().mean().item())
                err = check_close(f"16e B1 object {index} {name} (over {scale:.3f})", got_out / scale,
                                  ref_out / scale, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
                b1_rows.append(err[0] * scale)
    results["play"] = {"frames": len(frames), "mp4": "sequence.mp4" in written, "b1_objects_held": len(items),
                       "b1_max_abs_err": max(b1_rows)}
    print(f"16e play --script {PHASE16_SCRIPT}: {len(frames)} frames {IMAGE_SIZE[1]}x{IMAGE_SIZE[0]}, gif, "
          f"{'an mp4' if 'sequence.mp4' in written else 'no mp4 (no cv2 codec)'}; equal bit for bit to an in-memory "
          f"session of the restored models; its first B1 launch ({len(items)} objects) within "
          f"{max(b1_rows):.3e} of plain_adain_nerf; B4 at rollout_single's 1 x {frames_t} within {b4_err:.3e} of plain")

    # ---- 16f. a reference checkpoint of the same models, imported ------------
    env_state = torch.load(os.path.join(p2_path, ckpt.STATE_FILE), weights_only=True, map_location="cpu")["model"]
    play_state = torch.load(os.path.join(p3_path, ckpt.STATE_FILE), weights_only=True, map_location="cpu")
    std_exact = {"inexact": 0}
    original_running_std = layout.running_std

    def counted_running_std(var, exact=True):
        out = original_running_std(var, exact=False)
        std_exact["inexact"] += int((layout.std_variance(out) != layout._f32(var)).sum())
        return out

    layout.running_std = counted_running_std
    try:
        state_dict = layout.playable_state_dict(
            layout.flax_variables(play_state["model"]), [c.numpy() for c in play_state["centroids"]],
            environment=layout.flax_variables(env_state), scene=scene, exact=False)
    finally:
        layout.running_std = original_running_std
    reference = layout.torch_checkpoint(state_dict, os.path.join(directory, "reference.pth.tar"))
    imported = os.path.join(directory, "imported")
    _, seconds, _ = run_cli("playableenvironments_tpu_torch.cli.import_checkpoint", "--config", p3_config,
                            "--torch_checkpoint", reference, "--output", imported, "--phase3", "--device", device)
    frames_imported, seconds_play, _ = run_cli(
        "playableenvironments_tpu_torch.cli.play", "--config", p3_config,
        "--environment_checkpoint", ckpt.latest_checkpoint(os.path.join(imported, "environment")),
        "--playable_checkpoint", ckpt.latest_checkpoint(os.path.join(imported, "playable")),
        "--script", PHASE16_SCRIPT, "--output", os.path.join(directory, "play_imported"), "--device", device)
    import_err = max(float(np.abs(a - b).max()) for a, b in zip(frames_imported, frames))
    if import_err != 0.0:
        raise SmokeFailure(f"16f: play from the imported reference checkpoint differs from 16e's by {import_err:.3e}")
    results["import"] = {"state_dict_entries": len(state_dict), "import_s": seconds, "play_s": seconds_play,
                         "frame_max_abs_err": import_err, "inexact_running_std": std_exact["inexact"]}
    print(f"16f import: a reference torch.save of {len(state_dict)} entries (16b's environment under "
          f"environment_model., 16d's animation models; {std_exact['inexact']} action-network variances without an "
          f"exact float32 std) imported with --phase3 in {seconds:.2f} s; play from it equal to 16e's bit for bit")
    results["clis"] = clis
    results["paths"] = {"data_root": data_root, "environment": p2_path, "playable": p3_path}
    return results


@contextlib.contextmanager
def cli_directory():
    """A temporary directory for the CLI phases, removed afterwards."""
    import shutil
    import tempfile

    import torch

    # The CLIs' Logger mirrors to wandb where the package is installed; this
    # run reaches no network.
    os.environ["WANDB_MODE"] = "disabled"
    torch.cuda.empty_cache()
    directory = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        yield directory
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def phase16(repo):
    """16a-16f in a temporary directory it removes."""
    with cli_directory() as directory:
        return phase16_cli(repo, directory)


# Phase 17: the evaluation protocol from the command line, on phase 16's
# checkpoints and phase 11's test split (2 videos x 12 frames at 288x512).
# Cuts: the creators' windows of 4 observations (the CLIs' defaults, 16 and
# 8, exceed a 12-frame video), motion-masked MSE windows and FVD clips of 4
# (default 16); the playability evaluator keeps its CLI's defaults (no
# masked MSE in 12 frames, 8-frame FVD clips: one a video). Random data,
# seeded weights, so the metrics' values say nothing of quality.
PHASE17_OBSERVATIONS = 4
# The creators window the test split with training.batching's skip, 4 in
# tennis.yaml: a window of 4 observations would then span 16 frames, more
# than a 12-frame video holds, so phase 17 reads consecutive frames.
PHASE17_SKIP = 0
PHASE17_WINDOW = 4
PHASE17_CLIP = 4
# The CPU renders one window of each creator for the card-vs-CPU hold: the
# first PHASE17_OBSERVATIONS frames of video 0, cut into a dataset of their own.
# Card vs CPU, relative to the CPU's value, on the same two trees: the image
# metrics read the same PNGs in f32 (sums in another order); the VGG
# features and FID/FVD embeddings run cuDNN's default TF32 convolutions on
# the card, and FID/FVD then take an f64 sqrtm of few-sample covariances.
# On an NVIDIA H100 80GB HBM3 at 700.00 W this phase read at most 1.26e-7
# (MSE), 8.4e-8 (PSNR), 3.4e-8 (masked MSE), 1.35e-6 (SSIM), 1.14e-5
# (VGG) and 9.5e-4 (FID, FVD); the bounds are 5-30x that.
PHASE17_METRIC_RTOL = {"mse": 1e-6, "psnr": 1e-6, "ssim": 1e-5, "motion_masked_mse": 1e-6,
                       "vgg_cosine_similarity_selfconsistent": 1e-4, "fid": 5e-3, "fvd": 5e-3}
PHASE17_PNG_ATOL = 3 / 255  # tests/test_torch_port_encode.py's PNG bound
# B1's first launch of each creator, the kernel's largest distance from the
# same function summed in f64 over the plain version's on the same launch:
# both round their products to bf16. On an NVIDIA H100 80GB HBM3 at
# 700.00 W the kernel read 5.55e-2 to 6.00e-2 and the plain version 5.03e-2,
# a ratio of 1.10 to 1.19.
PHASE17_B1_F64_RATIO = 1.5


class Phase17Recorder:
    """Within the block: the first B1 group launch and the first B4 call on
    the card (their inputs, to hold them against the plain versions) and
    the first window each creator renders. The playability creator draws
    its few random numbers on the host itself, so the card's and the CPU's
    runs re-enact alike unpatched. The launch counters are the wrappers'
    own: nothing here launches."""

    def __enter__(self):
        from playableenvironments_tpu_torch.eval import creators
        from playableenvironments_tpu_torch.ops import fused_nerf
        from playableenvironments_tpu_torch.ops import fused_rollout as fr

        self.b1, self.b4, self.frames = None, None, None
        self._saved = [(fused_nerf, "fused_adain_nerf_group"), (fr, "_rollout_fwd"), (creators.FrameRenderer, "render")]
        self._saved = [(owner, name, getattr(owner, name)) for owner, name in self._saved]
        group, rollout, render = (original for _, _, original in self._saved)
        recorder = self

        def group_(cfg, items):
            outs = group(cfg, items)
            if recorder.b1 is None and items and items[0].encoded.is_cuda:
                recorder.b1 = (cfg, items, outs)
            return outs

        def rollout_(cfg, params, inputs, gt_count, collect_residuals, ms=None):
            if recorder.b4 is None and inputs[0].is_cuda:
                recorder.b4 = (cfg, params, [x.clone() for x in inputs], gt_count, collect_residuals)
            return rollout(cfg, params, inputs, gt_count, collect_residuals, ms)

        def render_(renderer, encoding):
            frames = render(renderer, encoding)
            if recorder.frames is None:
                recorder.frames = frames.float().cpu()
            return frames

        fused_nerf.fused_adain_nerf_group, fr._rollout_fwd = group_, rollout_
        creators.FrameRenderer.render = render_
        return self

    def __exit__(self, *exc):
        for owner, name, original in self._saved:
            setattr(owner, name, original)
        return False


def cut_test_split(source_root, target_root, frames):
    """`target_root`/test: the first `frames` frames of video 0 of
    `source_root`/test, written by the port's Video."""
    from playableenvironments_tpu_torch.data.video import MulticameraVideo

    video = MulticameraVideo().load(os.path.join(source_root, "test", "00000"))
    cut = MulticameraVideo([camera.subsample_split_resize(0, frames)[0] for camera in video.videos])
    cut.save(os.path.join(target_root, "test", "00000"))
    return target_root


def phase17_hold_b1(label, record, frames):
    """A recorded grouped B1 launch of `frames` frames against
    plain_adain_nerf: each object's output, frame by frame, in units of that
    frame's mean output magnitude where it exceeds 1 (phase 11's and 16e's
    unit, at phase 2's bounds). A frame's rows are its own render of the
    object, and the bf16 roundings that part kernel and plain version err
    in proportion to that render's activations. In the playability
    creator's first launch player 1's ground-truth frame reads a mean an
    order of magnitude above its re-enacted frames', so a unit taken over
    the whole launch fails an element of that frame where both versions
    sit ~5e-2 from the same function summed in f64 (scripts/
    check_b1_batch.py's reference). So the hold also fails unless the
    kernel's largest distance from the f64 sums is within
    PHASE17_B1_F64_RATIO times the plain version's.
    :return: (the largest error in output units, the launch's points, the
    largest distance of the kernel and of the plain version from the f64
    sums)."""
    import torch

    from playableenvironments_tpu_torch.ops import fused_nerf

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from check_b1_batch import f64_reference

    cfg, items, outs = record
    worst, from_f64 = 0.0, {"kernel": 0.0, "plain": 0.0}
    with torch.no_grad():
        for index, (item, (feats, alpha)) in enumerate(zip(items, outs)):
            args = (item.encoded, item.scale0, item.bias0, item.scale1, item.bias1, item.samples_per_ray)
            refs = fused_nerf.plain_adain_nerf(cfg, item.weights.packed, *args)
            exact = f64_reference(cfg, item.weights.packed, *args)
            for got, ref, r64 in zip((feats, alpha), refs, exact):
                from_f64["kernel"] = max(from_f64["kernel"], (got.double() - r64).abs().max().item())
                from_f64["plain"] = max(from_f64["plain"], (ref.double() - r64).abs().max().item())
            for name, got, ref in (("features", feats, refs[0]), ("alpha", alpha, refs[1])):
                if ref.shape[0] % frames:
                    raise SmokeFailure(f"17 {label} B1 object {index}: {ref.shape[0]} rows for {frames} frames")
                for frame, (g, r) in enumerate(zip(got.chunk(frames), ref.chunk(frames))):
                    scale = max(1.0, r.abs().mean().item())
                    err = check_close(f"17 {label} B1 object {index} {name} frame {frame} (over {scale:.3f})",
                                      g / scale, r / scale, KERNEL_ATOL, KERNEL_RTOL, KERNEL_MEAN_ATOL)
                    worst = max(worst, err[0] * scale)
    if not from_f64["kernel"] <= PHASE17_B1_F64_RATIO * from_f64["plain"]:
        raise SmokeFailure(f"17 {label} B1: the kernel {from_f64['kernel']:.3e} from the f64 sums, over "
                           f"{PHASE17_B1_F64_RATIO} times the plain version's {from_f64['plain']:.3e}")
    return worst, sum(item.encoded.shape[0] for item in items), from_f64


def phase17_hold_b4(record):
    """The recorded B4 call against plain_rollout_fwd (phase 8's bounds,
    relative to each output's largest magnitude)."""
    import torch

    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    cfg, params, inputs, gt_count, collect = record
    launches = fr.fused_rollout_fwd.launches  # the hold's own launch is no part of the path's count
    with torch.no_grad():
        got = fr.fused_rollout_fwd(cfg, params, *inputs, gt_count, collect)[0]
        ref = fr.plain_rollout_fwd(cfg, params, *inputs, gt_count, collect)[0]
    fr.fused_rollout_fwd.launches = launches
    return max(rel_close(f"17 B4 {k}", g, r)[0] for k, g, r in zip(("rot", "trans", "style", "deform"), got, ref))


def phase17_cli(repo, directory, paths, devices=("cuda", "cpu")):
    """17a-17c (module docstring) in `directory`, from phase 16's
    checkpoints and dataset (`paths`). Each CLI's wall seconds, its timing
    file's split and launches, its peak memory; each creator's frames a
    second; the evaluators' results on both devices."""
    import pathlib

    import numpy as np

    from playableenvironments_tpu_torch.data.video import _load_image
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    card, host = devices
    module = "playableenvironments_tpu_torch.cli."
    data_root = paths["data_root"]
    cut_root = cut_test_split(data_root, os.path.join(directory, "data_cut"), PHASE17_OBSERVATIONS)
    configs = {label: phase16_config(repo, directory, f"phase17_{label}", root,
                                     **{"training.batching": {"skip_frames": PHASE17_SKIP}})
               for label, root in (("card", data_root), ("cpu", cut_root), ("cpu_eval", data_root))}
    results_dirs = {label: os.path.join(directory, "results", f"phase17_{label}") for label in configs}
    generate = {
        "reconstructed": ("generate_reconstructed_dataset", ["--checkpoint", paths["environment"]]),
        "camera": ("generate_reconstructed_camera_manipulation_dataset",
                   ["--checkpoint", paths["environment"], "--observations_count", PHASE17_OBSERVATIONS]),
        "playability": ("generate_reconstructed_playability_dataset",
                        ["--environment_checkpoint", paths["environment"], "--playable_checkpoint", paths["playable"],
                         "--observations_count", PHASE17_OBSERVATIONS]),
    }
    clis, trees, holds = {}, {}, {}

    def timing(label, cli):
        with open(os.path.join(results_dirs[label], f"timing_{cli}.json")) as f:
            return json.load(f)

    # ---- 17a. the three creators on the card, then one window of each on the CPU
    fused_nerf.fused_adain_nerf.launches = fr.fused_rollout_fwd.launches = 0
    for name, (cli, args) in generate.items():
        output = os.path.join(directory, "trees", f"{name}_card")
        with Phase17Recorder() as recorder:
            _, seconds, peak = run_cli(module + cli, "--config", configs["card"], *args, "--output", output,
                                       "--device", card)
        t = timing("card", cli)
        written = len(list(pathlib.Path(output).rglob("*.png")))
        clis[cli] = {"wall_s": seconds, "peak_bytes": peak, "frames": written,
                     "frames_per_s": written / t["seconds"]["steps"], **t}
        trees[name] = output
        cpu_output = os.path.join(directory, "trees", f"{name}_cpu")
        with Phase17Recorder() as cpu_recorder:
            _, cpu_seconds, _ = run_cli(module + cli, "--config", configs["cpu"], *args, "--output", cpu_output,
                                        "--device", host)
        # The first window's frames before quantization (1e-2, the frame
        # bound of tests/test_torch_port_encode.py) and its PNGs after it.
        got, ref = recorder.frames, cpu_recorder.frames
        frames_err = float((got[:ref.shape[0], :ref.shape[1]] - ref).abs().max())
        png_err = 0.0
        for camera_dir in sorted(p for p in pathlib.Path(cpu_output, "00000").iterdir() if p.is_dir()):
            for png in sorted(camera_dir.glob("*.png")):
                card_png = os.path.join(output, "00000", camera_dir.name, png.name)
                png_err = max(png_err, float(np.abs(_load_image(card_png) - _load_image(str(png))).max()))
        if not (frames_err <= FRAME_ATOL and png_err <= PHASE17_PNG_ATOL + 1e-6):
            raise SmokeFailure(f"17a {cli}: card vs CPU frames {frames_err:.3e} (bound {FRAME_ATOL}), "
                               f"PNGs {png_err:.4f} (bound {PHASE17_PNG_ATOL:.4f})")
        holds[name] = {"frames_max_abs_err": frames_err, "png_max_abs_err": png_err, "cpu_wall_s": cpu_seconds}
        if card != "cpu":
            # Each creator's first render is 4 frames: a batch of 4 single
            # observations, or one window of 4.
            (holds[name]["b1_max_abs_err"], holds[name]["b1_points"],
             holds[name]["b1_from_f64"]) = phase17_hold_b1(
                name, recorder.b1, recorder.frames.shape[0] * recorder.frames.shape[1] * recorder.frames.shape[2])
            if name == "playability":
                holds[name]["b4_max_rel_err"] = phase17_hold_b4(recorder.b4)
        launches = {k: v for k, v in t["launches"].items() if v}
        print(f"17a {cli}: {seconds:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in t['seconds'].items())}), "
              f"{written} frames at {clis[cli]['frames_per_s']:.2f} frames/s, peak {peak / 1e9:.2f} GB, launches "
              f"{launches}; the first window card vs CPU: frames {frames_err:.3e}, PNGs {png_err:.4f}"
              + (f"; B1's first launch ({holds[name]['b1_points']} points) within "
                 f"{holds[name]['b1_max_abs_err']:.3e} of plain (kernel and plain "
                 f"{holds[name]['b1_from_f64']['kernel']:.3e} and {holds[name]['b1_from_f64']['plain']:.3e} "
                 "from the f64 sums)" if "b1_max_abs_err" in holds[name] else "")
              + (f"; B4's first call within {holds[name]['b4_max_rel_err']:.3e} of plain (relative)"
                 if "b4_max_rel_err" in holds[name] else ""))
    main_path = {"fused_adain_nerf": fused_nerf.fused_adain_nerf.launches,
                 "fused_rollout_fwd": fr.fused_rollout_fwd.launches}
    if card != "cpu" and not all(main_path.values()):
        raise SmokeFailure(f"17a: a kernel of the path was not launched: {main_path}")
    for name, (cli, _) in generate.items():
        want = {"fused_adain_nerf": True, "fused_rollout_fwd": name == "playability"}
        got = {k: bool(clis[cli]["launches"].get(k)) for k in want}
        if card != "cpu" and got != want:
            raise SmokeFailure(f"17a {cli}: launches {clis[cli]['launches']}, expected {want}")

    # ---- 17b. the four evaluators and fid on the card's trees, card then CPU
    reference = os.path.join(data_root, "test")
    evaluate = {
        "evaluate_reconstructed_dataset": (trees["reconstructed"], ["--window_size", PHASE17_WINDOW]),
        "evaluate_reconstructed_camera_manipulation_dataset": (trees["camera"], ["--window_size", PHASE17_WINDOW]),
        "evaluate_reconstructed_playability_dataset": (trees["playability"], []),
        "evaluate_fvd_reconstructed_dataset": (trees["reconstructed"], ["--clip_length", PHASE17_CLIP]),
    }
    metrics = {}
    for cli, (tree, args) in evaluate.items():
        outs = {}
        for label, device in (("card", card), ("cpu_eval", host)):
            out, seconds, peak = run_cli(module + cli, "--config", configs[label], "--generated", tree, *args,
                                         "--device", device)
            outs[label] = out
            if label == "card":
                t = timing(label, cli)
                clis[cli] = {"wall_s": seconds, "peak_bytes": peak, **t}
            else:
                clis[cli]["cpu_wall_s"] = seconds
        if set(outs["card"]) != set(outs["cpu_eval"]):
            raise SmokeFailure(f"17b {cli}: keys {sorted(outs['card'])} on the card, "
                               f"{sorted(outs['cpu_eval'])} on the CPU")
        rel = {}
        for key, value in outs["cpu_eval"].items():
            got = outs["card"][key]
            if isinstance(value, str) or key not in PHASE17_METRIC_RTOL:
                if not (got == value or (np.isnan(got) and np.isnan(value))):
                    raise SmokeFailure(f"17b {cli} {key}: {got} on the card, {value} on the CPU")
                continue
            rel[key] = abs(got - value) / max(abs(value), 1e-30)
            if not (np.isfinite(got) and rel[key] <= PHASE17_METRIC_RTOL[key]):
                raise SmokeFailure(f"17b {cli} {key}: {got} on the card, {value} on the CPU ({rel[key]:.3e} relative, "
                                   f"bound {PHASE17_METRIC_RTOL[key]})")
        metrics[cli] = {"card": outs["card"], "cpu": outs["cpu_eval"], "relative_error": rel}
        t = clis[cli]["seconds"]
        print(f"17b {cli}: {clis[cli]['wall_s']:.2f} s on the card (decode {t.get('decode', 0):.2f} s, metrics "
              f"{t.get('metrics', 0):.2f} s, networks {t.get('networks', 0):.2f} s), peak "
              f"{clis[cli]['peak_bytes'] / 1e9:.2f} GB, {clis[cli]['cpu_wall_s']:.2f} s on the CPU; card vs CPU "
              f"relative {', '.join(f'{k} {v:.2e}' for k, v in rel.items())}; "
              + ", ".join(f"{k} {v!r}" if isinstance(v, str) else f"{k} {v:.6g}" for k, v in sorted(outs["card"].items())))
    plots = sorted(os.listdir(os.path.join(results_dirs["card"], "plots")))
    if not plots:
        raise SmokeFailure("17b: the playability evaluator wrote no plots")
    fids = {}
    for label, device in (("card", card), ("cpu", host)):
        fids[label], seconds, peak = run_cli(module + "fid", reference, trees["reconstructed"], "--device", device)
        clis.setdefault("fid", {})[f"{label}_wall_s"] = seconds
        if label == "card":
            clis["fid"]["peak_bytes"] = peak
    fid_rel = abs(fids["card"] - fids["cpu"]) / max(abs(fids["cpu"]), 1e-30)
    if not fid_rel <= PHASE17_METRIC_RTOL["fid"]:
        raise SmokeFailure(f"17b fid: {fids['card']} on the card, {fids['cpu']} on the CPU")
    metrics["fid"] = {"card": fids["card"], "cpu": fids["cpu"], "relative_error": fid_rel}
    print(f"17b fid {reference} vs the reconstructed tree: {fids['card']:.6g} on the card in "
          f"{clis['fid']['card_wall_s']:.2f} s, {fids['cpu']:.6g} on the CPU ({fid_rel:.2e} relative); plots {plots}")
    return {"clis": clis, "holds": holds, "metrics": metrics, "main_path_launches": main_path, "plots": plots,
            "trees": trees}


def phase17(repo):
    """Phase 16's CLIs (for their checkpoints), then 17, in a temporary
    directory it removes."""
    with cli_directory() as directory:
        return phase17_cli(repo, directory, phase16_cli(repo, directory)["paths"])


# Phase 18: evaluation finished on the card, on phase 16's dataset (its train
# split of 2 x 40 frames at 288x512) and phase 17's reconstructed tree (B1's
# renders of the 2 x 12 test frames). Cuts: the detector trains
# PHASE18_STEPS steps of the published default 1000 at the CLI's batch 8,
# with one val evaluation over PHASE18_DETECTOR's eval_batches (the dataset
# has no val split: the train split stands for it, as the CLI does). At 50
# and 300 steps the eval-mode detector found nothing (its batch norms'
# running statistics, momentum 0.99, still lag the moving weights: train
# mode scored the players 0.95, eval mode under 0.12; 96x160 frames on
# this sandbox's CPU), at 500 every player. The seeded models' renders
# hold no players, so 17's tree reads MDR 1 whatever the detector; the
# test split itself, as a generated tree, gives the detection metrics
# something to find. The other metrics run on seeded or synthesized
# weights, so their values say nothing of quality.
PHASE18_STEPS = 500
PHASE18_BATCH = 8
PHASE18_DETECTOR = {"base_features": 32, "eval_freq": PHASE18_STEPS, "eval_batches": 2}
# One detector step card vs CPU from the same weights and batch, both in
# full-precision convolutions (ieee_convolutions), held as phase 15's steps
# are (the biases before the batch norms, stem and down1, have noise
# gradients, held to 2 lr), and the card's gradients against the same step
# on the CPU in float64: the step is ill-conditioned in f32 (the batch
# norms' E[x^2] - E[x]^2 over ~300,000 values a channel, the focal loss
# summed over 73,728 cells), so the bounds come from f32's own distance
# from f64. On an NVIDIA H100 80GB HBM3 at 700.00 W the first reading was
# the loss 1.35e-5 relative and stem.weight's gradient 5.5e-4 of its
# module's largest from the CPU's, where the CPU's f32 step itself sits
# 7.1e-6 and 1.2e-3 from f64 (this sandbox's CPU); the bounds are ~4x the
# card's reading, and the card's gradients may be no farther from f64 than
# PHASE18_F64_FACTOR times the CPU's.
TOLERANCES_18 = dict(loss_rtol=5e-5, stats_tol=1e-4, grad_tol=2e-3, norm_tol=2e-3, cosine=0.9999)
PHASE18_F64_FACTOR = 2.0
# The detection metrics of one detector checkpoint on one tree, card vs CPU,
# the card on cuDNN's default TF32: a peak within rounding of detect_fn's
# 0.3 or a match within rounding of the evaluator's 0.1 may flip, so MDR
# may move by one reference in PHASE18_MDR_REFERENCES; ADD, where MDR is
# equal, within 1e-3 relative.
PHASE18_MDR_REFERENCES = 1
PHASE18_ADD_RTOL = 1e-3
# The evaluator with LPIPS and a pretrained-layout VGG19, card (default TF32
# convolutions) vs CPU, relative; the image metrics at phase 17's bounds.
# The converted VGG19's similarity read 1.28e-4 where 1e-4 was set (my chip
# run 2, NVIDIA H100 80GB HBM3, 700.00 W): its He-scaled weights carry
# larger activations through TF32 than the seeded VGG of phase 17 (1.1e-5).
# Run 3 read LPIPS 2.05e-4 and the similarity 1.27e-4 on the whole tree.
PHASE18_METRIC_RTOL = {**{k: v for k, v in PHASE17_METRIC_RTOL.items() if k in ("mse", "psnr", "ssim",
                                                                                 "motion_masked_mse")},
                       "lpips": 1e-3, "vgg_cosine_similarity": 5e-4}
# I3D on one clip, card vs CPU, both IEEE f32 (the network's own context):
# the largest logit difference over the largest logit.
PHASE18_CLIP = (1, 16, 224, 224)
PHASE18_I3D_RTOL = 1e-4


def _detector_step(trainer, images, boxes, validity):
    """One DetectorTrainer step as _card_cpu_checks reads it: (loss, the
    other losses, the gradients, the model's state after the step)."""
    losses = trainer.train_step(images, boxes, validity)
    grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}
    state = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    return losses["loss"], {k: v for k, v in losses.items() if k != "loss"}, grads, state


def phase18_detector_card_vs_cpu(images, boxes, validity, base_features=32, devices=("cuda", "cpu")):
    """One detector train step on the card and on the CPU from the same
    seeded weights and batch, in full-precision convolutions, at
    TOLERANCES_18, and the same step on the CPU in float64 as the
    gradients' reference (PHASE18_F64_FACTOR). :return: the worst errors
    (_card_cpu_checks) and each f32 step's loss distance from f64."""
    from playableenvironments_tpu_torch.train.trainer_detector import DetectorTrainer, DetectorTrainingConfig

    cfg = DetectorTrainingConfig(base_features=base_features)
    readings = []
    for device in devices:
        trainer = DetectorTrainer(cfg, device=device, seed=0)
        with ieee_convolutions(device):
            readings.append(_detector_step(trainer, images, boxes, validity))
    trainer = DetectorTrainer(cfg, device="cpu", seed=0)
    trainer.model.double()
    f64 = _detector_step(trainer, images.double(), boxes.double(), validity)
    worst = _card_cpu_checks("18a detector step", readings[0], readings[1], cfg.learning_rate, reference=f64,
                             reference_factor=PHASE18_F64_FACTOR, **TOLERANCES_18)
    loss64 = f64[0].item()
    worst.update(f64_loss=loss64, **{f"{label}_loss_from_f64": abs(reading[0].item() - loss64) / abs(loss64)
                                     for label, reading in zip(("card", "cpu"), readings)})
    return worst


def metric_networks(directory, device):
    """LPIPS on synthesized lpips/VGG16 published-layout states and a VGG19
    to relu3_1 from a synthesized torchvision VGG19 file read by
    load_torch_vgg_weights, on `device`: (lpips_fn, vgg)."""
    import torch

    from playableenvironments_tpu_torch.compat import metric_weights as mw
    from playableenvironments_tpu_torch.compat import weight_validation as wv
    from playableenvironments_tpu_torch.eval.perceptual import (LPIPS, VGG19_CUTS, VGG19_PLAN, VGGFeatures,
                                                                load_torch_vgg_weights, lpips_distance_fn)

    lpips = mw.load_converted(LPIPS(), mw.convert_lpips_state_dict(
        wv.synthesize_state("lpips_vgg_keys.json", seed=2), wv.synthesize_state("vgg16_torch_keys.json", seed=3)))
    path = os.path.join(directory, "vgg19.pth")
    torch.save({k: torch.from_numpy(v) for k, v in wv.synthesize_state("vgg19_torch_keys.json", seed=4).items()}, path)
    vgg = load_torch_vgg_weights(path, VGGFeatures(VGG19_PLAN, VGG19_CUTS[:3]))
    return lpips_distance_fn(lpips.to(device).eval()), vgg.to(device).eval()


def phase18_cli(repo, directory, paths, tree, devices=("cuda", "cpu")):
    """18a-18c (above) in `directory`, from phase 16's dataset (`paths`)
    and phase 17's reconstructed tree (`tree`)."""
    import numpy as np
    import torch

    from playableenvironments_tpu_torch.cli.common import RunTimes
    from playableenvironments_tpu_torch.compat import metric_weights as mw
    from playableenvironments_tpu_torch.compat import weight_validation as wv
    from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
    from playableenvironments_tpu_torch.eval.evaluators import ReconstructedDatasetEvaluator
    from playableenvironments_tpu_torch.eval.i3d import I3D, i3d_video_embedder
    from playableenvironments_tpu_torch.train.trainer_detector import dataset_detection_batches

    card, host = devices
    module = "playableenvironments_tpu_torch.cli."
    data_root = paths["data_root"]
    config = phase16_config(repo, directory, "phase18", data_root, detector_training=PHASE18_DETECTOR)
    results_dir = os.path.join(directory, "results", "phase18")
    results = {}

    # ---- 18a. one step card vs CPU, then train_detector on the card ------------
    dataset = MulticameraVideoDataset(os.path.join(data_root, "train"), observations_count=1)
    batch = next(dataset_detection_batches(dataset, PHASE18_BATCH, shuffle=False))
    start = time.perf_counter()
    step = phase18_detector_card_vs_cpu(*batch, base_features=PHASE18_DETECTOR["base_features"], devices=devices)
    results["step_card_vs_cpu"] = {**step, "seconds": time.perf_counter() - start}
    print(f"18a one detector step at base_features {PHASE18_DETECTOR['base_features']} on "
          f"{tuple(batch[0].shape)} card vs CPU in full-precision convolutions: loss {step['loss']:.6f} / "
          f"{step['ref_loss']:.6f} (f64 {step['f64_loss']:.6f}: the card {step['card_loss_from_f64']:.3e}, the CPU "
          f"{step['cpu_loss_from_f64']:.3e} relative from it); {_describe_checks(step)}")
    out, seconds, peak = run_cli(module + "train_detector", "--config", config, "--max_steps", PHASE18_STEPS,
                                 "--batch_size", PHASE18_BATCH, "--device", card)
    with open(os.path.join(results_dir, "timing_train_detector.json")) as f:
        timing = json.load(f)
    losses = out["losses"]
    step_ms = statistics.median(timing["step_seconds"][2:]) * 1e3
    if not (len(losses) == PHASE18_STEPS and np.isfinite(losses).all() and losses[-1] < losses[0]
            and out["validation"] is not None and out["validation"]["missed_detection_rate"] < 1):
        raise SmokeFailure(f"18a train_detector: losses {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps, "
                           f"validation {out['validation']}")
    results["train_detector"] = {"wall_s": seconds, "peak_bytes": peak, "step_ms": step_ms, "first_loss": losses[0],
                                 "last_loss": losses[-1], "losses": losses, "validation": out["validation"], **timing}
    split = ", ".join(f"{k} {v:.2f} s" for k, v in timing["seconds"].items())
    print(f"18a train_detector: {PHASE18_STEPS} steps at bs {PHASE18_BATCH} x {tuple(batch[0].shape[1:3])} in "
          f"{seconds:.2f} s ({split}), median step {step_ms:.3f} ms from step 3, peak {peak / 1e9:.2f} GB; loss "
          f"{losses[0]:.4f} at step 1, {losses[-1]:.4f} at step {PHASE18_STEPS}; val "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["validation"].items()))

    # ---- 18b. the detection metrics from the CLI, and LPIPS and a VGG19 in code --
    reference = os.path.join(data_root, "test")
    references = sum(int(np.asarray(camera.bounding_boxes_validity, bool).sum())
                     for video in MulticameraVideoDataset(reference, observations_count=1).videos
                     for camera in video.videos)
    results["detection"] = {"references": references}
    for name, generated in (("reconstructed", tree), ("test_split", reference)):
        outs = {}
        for label, device in (("card", card), ("cpu", host)):
            outs[label], seconds, peak = run_cli(
                module + "evaluate_reconstructed_dataset", "--config", config, "--generated", generated,
                "--window_size", PHASE17_WINDOW, "--no_fid", "--detector_checkpoint", out["checkpoint"], "--output",
                os.path.join(directory, f"phase18_{name}_{label}.yaml"), "--device", device)
            with open(os.path.join(results_dir, "timing_evaluate_reconstructed_dataset.json")) as f:
                outs[f"{label}_timing"] = {"wall_s": seconds, "peak_bytes": peak, **json.load(f)}
        mdr = {label: outs[label]["missed_detection_rate"] for label in ("card", "cpu")}
        add = {label: outs[label]["average_detection_distance"] for label in ("card", "cpu")}
        mdr_moved = round(abs(mdr["card"] - mdr["cpu"]) * references)
        add_rel = abs(add["card"] - add["cpu"]) / max(abs(add["cpu"]), 1e-30)
        if not (mdr_moved <= PHASE18_MDR_REFERENCES and (mdr_moved or add_rel <= PHASE18_ADD_RTOL)):
            raise SmokeFailure(f"18b detection on {name} card vs CPU: MDR {mdr}, ADD {add} over {references} "
                               "references")
        if name == "test_split" and not mdr["cpu"] < 1:
            raise SmokeFailure(f"18b the trained detector finds no player of the test split: MDR {mdr}")
        results["detection"][name] = {"card": outs["card"], "cpu": outs["cpu"], "mdr_references_moved": mdr_moved,
                                      "add_relative_error": add_rel, "card_timing": outs["card_timing"],
                                      "cpu_wall_s": outs["cpu_timing"]["wall_s"]}
        t = outs["card_timing"]["seconds"]
        print(f"18b evaluate_reconstructed_dataset --detector_checkpoint on {name} ({generated}): MDR "
              f"{mdr['card']:.6f} (CPU {mdr['cpu']:.6f}, {mdr_moved} of {references} references moved), ADD "
              f"{add['card']:.6g} (CPU {add['cpu']:.6g}, {add_rel:.2e} relative); {outs['card_timing']['wall_s']:.2f} s "
              f"on the card (decode {t.get('decode', 0):.2f} s, metrics {t.get('metrics', 0):.2f} s, networks "
              f"{t.get('networks', 0):.2f} s), peak {outs['card_timing']['peak_bytes'] / 1e9:.2f} GB, "
              f"{outs['cpu_timing']['wall_s']:.2f} s on the CPU")
    # The first video of each tree (12 frames), linked into trees of its
    # own: the CPU's LPIPS is the slowest half of phase 18.
    first = {}
    for name, source in (("reference", reference), ("generated", tree)):
        first[name] = os.path.join(directory, f"phase18_first_{name}")
        os.makedirs(first[name], exist_ok=True)
        os.symlink(os.path.join(source, "00000"), os.path.join(first[name], "00000"))
    built = {}
    for label, device in (("card", card), ("cpu", host)):
        lpips_fn, vgg = metric_networks(directory, device)
        times = RunTimes()
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        got = ReconstructedDatasetEvaluator(window_size=PHASE17_WINDOW, lpips_fn=lpips_fn, compute_fid=False,
                                            vgg=vgg, device=device, times=times).compute_metrics(
                                                first["reference"], first["generated"])
        built[label] = {"results": got, "wall_s": time.perf_counter() - start, "seconds": times.meter.summary(),
                        "peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
    rel = {key: abs(built["card"]["results"][key] - built["cpu"]["results"][key])
           / max(abs(built["cpu"]["results"][key]), 1e-30) for key in PHASE18_METRIC_RTOL}
    over = {key: value for key, value in rel.items()
            if not (np.isfinite(built["card"]["results"][key]) and value <= PHASE18_METRIC_RTOL[key])}
    if over:
        raise SmokeFailure(f"18b the evaluator card vs CPU, relative: {rel}; over PHASE18_METRIC_RTOL: {over}")
    if set(built["card"]["results"]) != set(built["cpu"]["results"]):
        raise SmokeFailure(f"18b evaluator keys {sorted(built['card']['results'])} on the card, "
                           f"{sorted(built['cpu']['results'])} on the CPU")
    results["evaluator"] = {**built, "relative_error": rel}
    t = built["card"]["seconds"]
    print(f"18b the evaluator with LPIPS and a converted VGG19 on the first video: {built['card']['wall_s']:.2f} s on "
          f"the card (networks "
          f"{t.get('networks', 0):.2f} s), peak {built['card']['peak_bytes'] / 1e9:.2f} GB, "
          f"{built['cpu']['wall_s']:.2f} s on the CPU; card vs CPU relative "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + "; "
          + ", ".join(f"{k} {v:.6g}" for k, v in sorted(built["card"]["results"].items())))

    # ---- 18c. validate_metric_weights on the card; I3D card vs CPU -------------
    try:
        report, seconds, peak = run_cli(module + "validate_metric_weights", "--device", card)
    except SystemExit as e:
        raise SmokeFailure(f"18c validate_metric_weights: {e}") from None
    gaps = {name: wv.largest_relative_gap(verdict["computed"], verdict["golden"]) for name, verdict in report.items()}
    if {name: verdict["status"] for name, verdict in report.items()} != dict.fromkeys(
            ("inception_v3", "i3d", "lpips", "vgg19"), "PASS"):
        raise SmokeFailure(f"18c validate_metric_weights: {report}")
    results["validate_metric_weights"] = {"wall_s": seconds, "peak_bytes": peak, "largest_relative_gap": gaps}
    print(f"18c validate_metric_weights on the card: all PASS in {seconds:.2f} s, peak {peak / 1e9:.2f} GB; largest "
          "relative gap to the golden " + ", ".join(f"{k} {v:.3e}" for k, v in sorted(gaps.items())))
    state = mw.convert_tfhub_i3d_variables(wv.synthesize_state("i3d_tfhub_keys.json", seed=1))
    clip = np.random.default_rng(18).random(PHASE18_CLIP + (3,)).astype(np.float32)
    logits, i3d_ms, i3d_peak = {}, None, None
    for device in (card, host):
        net = mw.load_converted(I3D(), state).to(device).eval()
        logits[device] = i3d_video_embedder(net)(clip)
        if torch.device(device).type == "cuda":
            x = torch.from_numpy(clip).to(device)
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                i3d_ms = cuda_ms(lambda: net(x), warmup=2, reps=10)
            i3d_peak = torch.cuda.max_memory_allocated()
    i3d_err = float(np.abs(logits[card] - logits[host]).max() / np.abs(logits[host]).max())
    if not i3d_err <= PHASE18_I3D_RTOL:
        raise SmokeFailure(f"18c I3D card vs CPU: {i3d_err:.3e} of the largest logit (bound {PHASE18_I3D_RTOL})")
    results["i3d"] = {"clip": PHASE18_CLIP, "ms": i3d_ms, "peak_bytes": i3d_peak, "max_rel_err": i3d_err}
    print(f"18c I3D on one {'x'.join(map(str, PHASE18_CLIP))} clip: {i3d_ms} ms on the card (IEEE f32), peak "
          f"{i3d_peak} bytes; card vs CPU {i3d_err:.3e} of the largest logit")
    return results


def phase18(repo):
    """Phase 16's CLIs (for the dataset and checkpoints), 17 (for its
    reconstructed tree), then 18, in a temporary directory it removes."""
    with cli_directory() as directory:
        paths = phase16_cli(repo, directory)["paths"]
        return phase18_cli(repo, directory, paths, phase17_cli(repo, directory, paths)["trees"]["reconstructed"])


def backbone_f32_entries(phase14_results):
    """The kernels line's entries of B2/B3 for f32 operands (phase 14): ms,
    plain, library and bound of one direct-ray step's four launches (two of
    each 14a direct-ray shape), launches on 14c's main path (the remat
    recompute's included) and on 14e's frames; the fine pass's largest
    launch apart."""
    k14 = {r["object"]: r for r in phase14_results["kernels"]}
    main14 = phase14_results["main_path"]
    entries = []
    for which, prefix, replaces in (("fwd", "", "playableenvironments_tpu/ops/fused_nerf.py:375"),
                                    ("bwd", "bwd_", "playableenvironments_tpu/ops/fused_nerf.py:404")):
        step = [k14[name] for name, _ in PHASE14_SHAPES]
        total = {key: 2 * sum(r[f"{prefix}{key}"] for r in step) for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "fp32_bound_ms", "tf32_bound_ms")}
        fine = k14["fine"]
        launches = main14["launches"][0 if which == "fwd" else 1]
        by_path = {"options_phase2": launches}
        extra = {}
        if which == "fwd":
            by_path["use_fine_frames"] = phase14_results["frames"]["frame_launches"]
            extra = {"image_ms": 2 * sum(r["image_ms"] for r in step), "image_launches": main14["launches"][4]}
        else:
            extra = {"breakdown_ms": {k: 2 * sum(r["bwd_breakdown_ms"][k] for r in step)
                                      for k in ("tile_ms", "dw_ms", "reduce_ms")},
                     "plain_f32_max_rel_err": max(r["bwd_plain_f32_max_rel_err"] for r in k14.values()),
                     "relu_flips_vs_plain_f32": {r["object"]: r["relu_flips_vs_plain_f32"] for r in k14.values()},
                     "relu_pattern_vs_f64": {r["object"]: r["relu_pattern_vs_f64"] for r in k14.values()}}
        entries.append({
            "name": f"backbone_f32_{which}", "route": "cuda",
            "source": "playableenvironments_tpu_torch/csrc/fused_backbone_f32.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": max(r[f"{which}_max_rel_err"] for r in k14.values()),
            **total, "bound_by": step[0][f"{prefix}bound_by"], "launches_by_path": by_path,
            "kernel_ms": 2 * sum(r[f"{prefix}kernel_ms"] for r in step), **extra,
            "ptxas": {k: v for k, v in ptxas_entries(BUILD_REPORTS.get("fused_backbone_f32.cu", "")).items()
                      if ("fwd" if which == "fwd" else "bwd_tile") in k or (which == "fwd" and "pack" in k)
                      or (which == "bwd" and ("dw_kernel" in k or "reduce" in k))},
            "main_path_launch": {"points": fine["points"], **{key: fine[f"{prefix}{key}"] for key in (
                "ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "fp32_bound_ms",
                "tf32_bound_ms")}},
        })
    return entries


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
    print("card and power limit: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                                    capture_output=True, text=True, check=True).stdout.strip())

    # Seconds of each phase, from the end of the one before.
    phase_seconds, clock = {}, [time.perf_counter()]

    def done(phase):
        clock.append(time.perf_counter())
        phase_seconds[phase] = round(clock[-1] - clock[-2], 1)

    # ---- 1. build (one nvcc per source, started together) ------------------
    start = time.perf_counter()
    reports = fused_nerf.build_kernels()
    BUILD_REPORTS.update(reports)
    print(f"build: {', '.join('csrc/' + name for name in reports)} in {time.perf_counter() - start:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip().split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    done("1")
    alone = {"12": phase12_minecraft, "13": phase13, "14": phase14, "15": phase15, "16": phase16, "17": phase17,
             "18": phase18}
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
        phase14_results = phase14(repo)
        done("14")
        phase15_results = phase15(repo)
        done("15")
        with cli_directory() as directory:
            phase16_results = phase16_cli(repo, directory)
            done("16")
            phase17_results = phase17_cli(repo, directory, phase16_results["paths"])
            done("17")
            phase18_results = phase18_cli(repo, directory, phase16_results["paths"],
                                          phase17_results["trees"]["reconstructed"])
            done("18")
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
                                "minecraft_reconstruction": phase12["data"]["creator_launches"][0],
                                "chain_play": phase15_results["chain"]["play"]["launches"]},
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
            "tennis_decoder_consistency": phase15_results["consistency"]["with"]["launches"][which == "bwd"],
            "chain_phase2": phase15_results["chain"]["phase2"]["launches"][which == "bwd"],
        }
        entry["decoder_path_launch"] = {k: row[k] for k in ("points", "ms", "plain_ms", "library_ms", "bound_ms",
                                                            "bound_by", "max_abs_err")}
    kernels += backbone_f32_entries(phase14_results)
    p11 = phase11["phase3"]
    for entry, which in zip(kernels[3:5], (0, 1)):
        entry["launches_by_path"] = {"phase3": phase3["launches"][which], "phase3_cache": p11["cache_launches"][which],
                                     "phase3_batch": p11["batch_launches"][which],
                                     "minecraft_phase3_cache": phase12["phase3"]["launches"][which],
                                     "chain_phase3": phase15_results["chain"]["phase3"]["launches"][which]}
    # Every kernel's launches in each CLI run of phase 16 (its timing file's
    # counts: B1 in the evaluators' renders and play, B2-f32/B3-f32 in
    # phase 2, B4/B5 in phase 3 and B4 alone in the evaluator's
    # rollout_single); B1 and B4 held on that path too.
    for entry in kernels:
        entry.setdefault("launches_by_path", {}).update({
            f"cli_{label}": cli["launches"][entry["name"]] for label, cli in phase16_results["clis"].items()
            if cli["launches"].get(entry["name"])})
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], phase16_results["play"]["b1_max_abs_err"])
    kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], phase16_results["b4_rollout_single"]["max_rel_err"])
    # Phase 17's creators: B1 in every render, B4 in the playability
    # creator's re-enactment; each held on its first launch's inputs.
    for entry in kernels:
        entry["launches_by_path"].update({
            f"cli_{cli}": run["launches"][entry["name"]] for cli, run in phase17_results["clis"].items()
            if run.get("launches", {}).get(entry["name"])})
    kernels[0]["max_abs_err"] = max([kernels[0]["max_abs_err"]] + [
        hold["b1_max_abs_err"] for hold in phase17_results["holds"].values()])
    kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], phase17_results["holds"]["playability"]["b4_max_rel_err"])
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
                   "phase13": phase13_results, "phase14": phase14_results, "phase15": phase15_results,
                   "phase16": phase16_results, "phase17": phase17_results, "phase18": phase18_results,
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
          "backbone_f32_fwd/bwd are fused_backbone_fwd/bwd's kernels for f32 operands (phase 14): their ms, "
          "plain, library (the f32 torch.matmul chain and its autograd) and bound sum one direct-ray step's four "
          "launches, `main_path_launch` is the fine pass's largest launch of 14c; "
          "fused_rollout bounds use the f32 peak "
          f"({PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), backbone_f32 the lower of that and the 3xTF32 one (three "
          f"TF32 operations at {PEAK_TF32_FLOPS / 1e12:.1f} TFLOP/s a multiply-add, both beside it), the others "
          f"the bf16 one ({PEAK_BF16_FLOPS / 1e12:.0f})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
