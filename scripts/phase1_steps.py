#!/usr/bin/env python3
"""A phase-1 trajectory, step by step, of the PyTorch port's VAE trainer:
what each step's loss terms are and where the largest posterior parameters
and batch-norm outputs come from.

    python3 scripts/phase1_steps.py [--batch 20] [--image 288 512] [--dtype bfloat16]
        [--variant v8] [--steps 6] [--device cuda|cpu] [--noise cpu|device] [--out PATH]

Builds chip_smoke.py's phase-1 main path (13e: seeded weights, perceptual
0.1, KL 5e-6, VGG19 on seeded random weights, images from numpy seed 0) at
the given batch and image size and runs `--steps` steps. `--noise cpu`
draws the posterior noise from CPU generators (seed 0) whatever the
device, so that a card run and a CPU run see the same draws; `--noise
device` draws it on the device, as 13e does. For each step it prints one
JSON line: the loss terms; per latent level its KL, largest log variance
and largest |mean| with their (image, row, column, channel), and the two
batch norms whose outputs sum to that log variance (log_variance_sources);
and the three batch norms with the largest |output| (module, channel, that
output, the channel's batch variance and its E[x^2] - E[x]^2 before the
clip).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def batch_norm_probes(torch, model):
    """Forward hooks on every train-mode BatchNorm of `model`: record, per
    module, the channel whose |output| is largest; keep the input and output
    of the encoder's last bottleneck block of each level (`kept`)."""
    from playableenvironments_tpu_torch.models.layers import BatchNorm

    records, kept = {}, {}
    counts = model.cfg.downsampling_layers_count
    last = {f"encoder.bottleneck_{s}_{model.cfg.bottleneck_blocks - 1}.{bn}"
            for s in range(len(counts)) for bn in ("bn2", "skip_bn")}

    def hook(name):
        def record(module, inputs, output):
            if not module.training:
                return
            x = inputs[0].detach().float()
            if name in last:
                kept[name] = (x, output.detach().float())
            mean = x.mean(dim=(0, 2, 3))
            raw = (x * x).mean(dim=(0, 2, 3)) - mean * mean
            peak = output.detach().float().abs().amax(dim=(0, 2, 3))
            channel = int(peak.argmax())
            records[name] = {"channel": channel, "max_abs_out": float(peak[channel]),
                             "batch_var": float(raw[channel].clamp_min(0.0)), "raw_var": float(raw[channel]),
                             "centred_var": float(((x[:, channel] - mean[channel]) ** 2).mean()),
                             "scale": float(module.weight[channel].detach())}
        return record

    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            module.register_forward_hook(hook(name))
    return records, kept


def log_variance_sources(torch, model, kept, level_idx, at):
    """The two batch norms whose outputs sum to the level's (mean ++ log
    variance) at `at` = (image, row, column, log-variance channel): each
    one's output there, and the share of its input channel's centred sum
    of squares that this one position holds (1 when the channel is constant
    but for it; the normalized output is then about sqrt(N), N the
    positions of the batch)."""
    features = model.cfg.bottleneck_features // 2 ** (sum(model.cfg.downsampling_layers_count)
                                                      - sum(model.cfg.downsampling_layers_count[:level_idx + 1]))
    block = f"encoder.bottleneck_{level_idx}_{model.cfg.bottleneck_blocks - 1}"
    n, h, w, c = at
    out = {}
    for bn in ("bn2", "skip_bn"):
        if f"{block}.{bn}" not in kept:
            continue
        x, y = kept[f"{block}.{bn}"]
        channel = x[:, features + c]
        centred = (channel - channel.mean()) ** 2
        out[bn] = {"output": float(y[n, features + c, h, w]), "share": float(centred[n, h, w] / centred.sum()),
                   "sqrt_positions": channel.numel() ** 0.5}
    return out


def level_summary(torch, level):
    """KL, largest log variance and |mean| of one (N, H, W, 2F) level."""
    from playableenvironments_tpu_torch.train.losses import spatial_kl_gaussian

    level = level.detach().float()
    half = level.shape[-1] // 2
    mean, log_variance = level[..., :half], level[..., half:]

    def where(t):
        flat = int(t.argmax())
        return [int(i) for i in torch.unravel_index(torch.tensor(flat), t.shape)]

    return {"kl": float(spatial_kl_gaussian(level)), "max_log_variance": float(log_variance.max()),
            "at": where(log_variance), "max_abs_mean": float(mean.abs().max()), "mean_at": where(mean.abs())}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=20)
    parser.add_argument("--image", type=int, nargs=2, default=(288, 512))
    parser.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    parser.add_argument("--variant", default="v8", choices=("v8", "v9"))
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--noise", default="cpu", choices=("cpu", "device"))
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from chip_smoke import phase1_trainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    trainer = phase1_trainer(args.variant, args.dtype, args.device)
    images = torch.from_numpy(np.random.default_rng(0).random((args.batch,) + tuple(args.image) + (3,), np.float32))
    images = images.to(trainer.device)
    rng = RngStreams(0, "cpu" if args.noise == "cpu" else trainer.device)
    probes, kept = batch_norm_probes(torch, trainer.model)
    lines = []
    for step in range(args.steps):
        trainer.model.train()
        trainer.optimizer.zero_grad()
        loss, metrics, out = trainer.compute_losses(images, rng)
        loss.backward()
        trainer.optimizer.step()
        top = sorted(probes.items(), key=lambda kv: -kv[1]["max_abs_out"])[:3]
        levels = [level_summary(torch, level) for level in out["encoded_observations"]]
        for i, level in enumerate(levels):
            level["sources"] = log_variance_sources(torch, trainer.model, kept, i, level["at"])
        line = {"step": step + 1, **{k: float(v.detach()) for k, v in metrics.items()}, "levels": levels,
                "largest_batch_norm_outputs": [{"module": name, **rec} for name, rec in top]}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "steps": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
