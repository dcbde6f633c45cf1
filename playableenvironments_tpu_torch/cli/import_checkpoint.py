"""Import a reference (PyTorch) checkpoint as port-native checkpoints.

Port of playableenvironments_tpu/cli/import_checkpoint.py:

    python -m playableenvironments_tpu_torch.cli.import_checkpoint --config <yaml> \
        --torch_checkpoint <pth.tar> [--output <dir>] [--phase3] [--device cuda|cpu]

The reference's `torch.save` dict (its model state_dict under "model", or a
bare state_dict; `module.` prefixes stripped) goes through
compat/torch_import.py into the flax trees that compat/from_flax.py loads,
strictly, into the configured model: a tree that does not match the
configuration fails there (the JAX CLI's shape check). The result is a
phase-2 checkpoint (train/checkpointing.py) under `--output` (default
`<checkpoints>/<run>/imported`); with `--phase3` the file is a phase-3
playable model (the frozen environment model under `environment_model.`,
the animation models under `object_animation_models.`) and the import
writes an `environment` and a `playable` checkpoint there, the latter
with the reference's centroids. The checkpoint file is unpickled in full,
so it must come from a trusted source.
"""

from __future__ import annotations

import argparse
import os


def load_torch_state_dict(path: str):
    """{name: numpy array} of a reference checkpoint file: the trainer's
    {"model": state_dict, ...} wrapper or a bare state_dict, without the
    `module.` prefix of a DataParallel model."""
    import numpy as np
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=False)
    state = payload.get("model", payload) if isinstance(payload, dict) else payload
    out = {}
    for key, value in state.items():
        out[key] = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
    if out and all(k.startswith("module.") for k in out):
        out = {k[len("module."):]: v for k, v in out.items()}
    return out


def _load_strictly(label: str, load, *args):
    """Run a compat.from_flax loader; a tree that does not match the
    configured model exits with the loader's reason."""
    try:
        left = load(*args)
    except (KeyError, ValueError) as error:
        raise SystemExit(f"the converted {label} does not match the configured model ({error}); check that "
                         "--config describes the checkpoint's architecture") from error
    if left:
        raise SystemExit(f"the converted {label} has no weights for {left}, or weights the configured model "
                         "has no place for; check that --config describes the checkpoint's architecture")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--torch_checkpoint", required=True)
    parser.add_argument("--output", default=None,
                        help="checkpoint directory (default: the config's checkpoints root under 'imported')")
    parser.add_argument("--step", type=int, default=0)
    parser.add_argument("--phase3", action="store_true",
                        help="the torch checkpoint is a phase-3 playable model; writes an environment and a "
                             "playable checkpoint")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    from playableenvironments_tpu_torch.cli.common import (
        build_environment_model, load_yaml, output_dirs, synthesis_training_config,
    )
    from playableenvironments_tpu_torch.compat import torch_import
    from playableenvironments_tpu_torch.compat.from_flax import load_environment_model, load_playable
    from playableenvironments_tpu_torch.train import checkpointing
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_yaml(args.config)
    state_dict = load_torch_state_dict(args.torch_checkpoint)
    env_model = build_environment_model(cfg, device=device)
    cameras = cfg.get("training", {}).get("batching", {}).get("allowed_cameras")
    env_state_dict = torch_import.split_state_dict(state_dict, "environment_model") if args.phase3 else state_dict
    params, batch_stats = torch_import.convert_environment_model(
        env_state_dict, env_model.scene, cameras_count=len(cameras) if cameras else 1)
    _load_strictly("environment model", load_environment_model, env_model,
                   {"params": params, "batch_stats": batch_stats})
    trainer = SynthesisTrainer(env_model, synthesis_training_config(cfg))

    output = args.output
    if output is None:
        output = os.path.join(output_dirs(cfg)[1], "imported")
    if not args.phase3:
        path = checkpointing.save_checkpoint(output, trainer, step=args.step)
        print(f"imported checkpoint written to {path}")
        return

    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train.trainer_playable import PlayableTrainer, PlayableTrainingConfig

    env_path = checkpointing.save_checkpoint(os.path.join(output, "environment"), trainer, step=args.step)
    print(f"imported environment checkpoint written to {env_path}")
    playable = PlayableEnvironmentModel(env_model.scene, device=device)
    anim_params, anim_stats, centroids = torch_import.convert_playable_model(
        state_dict, env_model.scene.animation_models)
    _load_strictly("playable model", load_playable, playable, {"params": anim_params, "batch_stats": anim_stats})
    playable_trainer = PlayableTrainer(playable, PlayableTrainingConfig())
    playable_trainer.init_extra()
    import torch

    playable_trainer.centroids = [torch.from_numpy(c.astype("float32")).to(device) for c in centroids]
    playable_path = checkpointing.save_checkpoint(os.path.join(output, "playable"), playable_trainer, step=args.step)
    print(f"imported playable checkpoint written to {playable_path}")


if __name__ == "__main__":
    main()
