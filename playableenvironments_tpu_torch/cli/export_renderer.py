"""Export a trained renderer as a serving artifact (torch.export).

Port of playableenvironments_tpu/cli/export_renderer.py. The artifact
carries the traced graph of the whole frame function (SceneEncoding ->
frames, B1 as its registered operator) with the weights, and serves
without the model code (playableenvironments_tpu_torch.serve):

    python -m playableenvironments_tpu_torch.cli.export_renderer --config <yaml> \
        --checkpoint <phase-2 checkpoint> --output renderer.pexp \
        [--playable_checkpoint <phase-3 checkpoint>] [--platforms cuda|cpu] [--seed 0]

The checkpoints are the port's own (train/checkpointing.py). The example
encoding is the first window of the `test` split, one observation. With
`--playable_checkpoint` the interactive bundle is exported too (render,
step0 and step artifacts; `--output` becomes their path prefix). An
artifact runs on one platform: the card by default, the CPU with
`--platforms cpu`; without a card the default raises.
"""

from __future__ import annotations

import argparse


def main() -> dict:
    parser = argparse.ArgumentParser(description="Export a serving renderer")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument(
        "--playable_checkpoint", default=None,
        help="also export the interactive bundle (step0/step artifacts) from this phase-3 checkpoint; --output "
        "becomes the path prefix",
    )
    parser.add_argument("--platforms", nargs="+", default=["cuda"],
                        help="the platform the artifact runs on: cuda or cpu (one)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    from playableenvironments_tpu_torch import serve
    from playableenvironments_tpu_torch.cli.common import load_yaml
    from playableenvironments_tpu_torch.cli.generate_reconstructed_dataset import build_renderer
    from playableenvironments_tpu_torch.utils.device import resolve_device

    if len(args.platforms) != 1:
        raise SystemExit("--platforms: an artifact runs on one platform (cuda or cpu); export once per target")
    device = resolve_device(args.platforms[0])
    cfg = load_yaml(args.config)
    renderer, dataset, env_model = build_renderer(cfg, args.checkpoint, device, seed=args.seed)
    batch = next(dataset.iterate_batches(1, shuffle=False))
    encoding = renderer.encode(batch)

    if args.playable_checkpoint:
        from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
        from playableenvironments_tpu_torch.train import checkpointing
        from playableenvironments_tpu_torch.train.trainer_playable import PlayableTrainer, PlayableTrainingConfig

        playable = PlayableEnvironmentModel(
            env_model.scene, with_discriminators=checkpointing.has_discriminators(args.playable_checkpoint),
            device=device, seed=args.seed)
        trainer = PlayableTrainer(playable, PlayableTrainingConfig(), environment_model=env_model)
        checkpointing.restore_checkpoint(args.playable_checkpoint, trainer)
        paths = serve.export_interactive(playable, renderer, encoding.map(lambda x: x[:, :1]), args.output,
                                         platforms=tuple(args.platforms))
        for kind, path in paths.items():
            print(f"exported {kind} -> {path}")
        return paths

    path = serve.export_renderer(renderer, encoding, args.output, platforms=tuple(args.platforms))
    artifact = serve.load_artifact(path)
    print(f"exported {artifact.header['name']} for {artifact.header['platforms']} -> {path}")
    return {"render": path}


if __name__ == "__main__":
    main()
