#!/usr/bin/env python3
"""Whether one phase-2 step is bit-reproducible on one CUDA card: the
reason chip_smoke.py 15c compares its resumed step with deterministic
algorithms.

    python3 scripts/step_determinism.py

Two trainers of chip_smoke.py 15c's phase 2 (configs/tennis.yaml at full
width with bench.py's bf16 fused-backbone overrides, the decoder path at
bs 1 x 4 of 288x512 random frames, seeded random weights) take one step.
Then, three times, the second is put in the first's state in memory
(chip_smoke.copy_trainer_state) and both take the same step on the same
draws: with PyTorch's defaults, with cuDNN's deterministic flag alone, and
with chip_smoke.deterministic_algorithms (torch.use_deterministic_algorithms
and cuDNN's flag). Prints, for each, the largest parameter difference, the
number of parameters and buffers that differ, and the worst parameters.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_determinism: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    cfg = chip_smoke.published_phase2_config(REPO, "tennis")
    bs, obs = chip_smoke.CHAIN_PHASE2
    batch = chip_smoke.decoder_batch(torch, "tennis", bs, obs, *chip_smoke.DECODER_IMAGE, "cuda")
    train_cfg = synthesis_training_config(cfg)
    first, second = (SynthesisTrainer(build_environment_model(cfg, device="cuda", seed=0), train_cfg)
                     for _ in range(2))
    for trainer in (first, second):
        trainer.train_step(batch, RngStreams(9, "cuda"))

    def one_step(label, seed):
        chip_smoke.copy_trainer_state(first, second)
        for trainer in (first, second):
            trainer.train_step(batch, RngStreams(seed, "cuda"))
        torch.cuda.synchronize()
        apart = sorted(((a - b).abs().max().item(), name) for (name, a), (_, b)
                       in zip(first.model.named_parameters(), second.model.named_parameters()))
        buffers = sum(not torch.equal(a, b) for a, b in zip(first.model.buffers(), second.model.buffers()))
        moved = [(f"{d:.3e}", name) for d, name in apart if d > 0]
        print(f"{label}: largest parameter difference {apart[-1][0]:.3e}; {len(moved)} of {len(apart)} "
              f"parameters and {buffers} buffers differ; worst {moved[-4:]}")

    one_step("defaults", 10)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True, allow_tf32=cudnn.allow_tf32):
        one_step("cuDNN deterministic", 11)
    with chip_smoke.deterministic_algorithms():
        one_step("deterministic algorithms", 12)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
