#!/usr/bin/env python3
"""Phase 1 over several steps, the PyTorch port against the JAX package on
the CPU, from the same weights and the same posterior noise.

    python3 tests/torch_port_phase1_replay.py [--batch 8] [--image 72 128] [--steps 7]
        [--dtype float32|bfloat16] [--variant v8] [--out PATH]

The port's trainer (the published v8 autoencoder widths, perceptual 0.1, KL
5e-6, VGG19 on the port's seeded random weights, images from numpy seed 0:
chip_smoke.py's 13e at another batch and image size) runs `--steps` steps
with its posterior noise from CPU generators (seed 0). The JAX package's
trainer starts from the port's initial autoencoder and VGG weights and
takes the same noise, step by step. Each step prints both sides' loss
terms and each latent level's largest log variance, so that a step where
the KL jumps shows on both sides or on one. Not a pytest module: a whole
trajectory at these sizes takes about a minute on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flax_tree(module, shapes):
    """The flax tree of `shapes` (a pytree of ShapeDtypeStructs) filled from
    `module`'s state dict: compat/from_flax.py's mapping, inverted."""
    import torch

    from playableenvironments_tpu_torch.compat.from_flax import _RENAMES

    state = module.state_dict()

    def fill(tree, prefix):
        out = {}
        for name, leaf in tree.items():
            path = f"{prefix}{name}"
            if hasattr(leaf, "items"):
                out[name] = fill(leaf, path + ".")
                continue
            head = prefix.rstrip(".")
            key = path if path in state else f"{head}.{_RENAMES.get(name, name)}".lstrip(".")
            tensor = state[key].detach().float()
            if name == "kernel":
                tensor = {2: lambda x: x.t(), 3: lambda x: x.permute(2, 1, 0),
                          4: lambda x: x.permute(2, 3, 1, 0)}[tensor.dim()](tensor)
            assert tuple(tensor.shape) == tuple(leaf.shape), (path, tuple(tensor.shape), leaf.shape)
            out[name] = np.ascontiguousarray(tensor.numpy(), np.float32)
        return out

    with torch.no_grad():
        return fill(shapes, "")


def level_summary(levels):
    """Largest log variance of each (N, H, W, 2F) level."""
    return [float(np.asarray(level, np.float32)[..., level.shape[-1] // 2:].max()) for level in levels]


def port_trajectory(args):
    """(initial autoencoder and VGG modules' copies, per-step records,
    noise draws) of the port's run."""
    import copy

    import torch

    from playableenvironments_tpu_torch.config import AutoencoderConfig
    from playableenvironments_tpu_torch.train.trainer_autoencoder import (
        AutoencoderTrainer, AutoencoderTrainingConfig,
    )
    from playableenvironments_tpu_torch.utils.random import RngStreams

    trainer = AutoencoderTrainer(AutoencoderConfig(variant=args.variant, compute_dtype=args.dtype),
                                 AutoencoderTrainingConfig(perceptual_lambda=0.1, kl_lambda=5e-6), device="cpu", seed=0)
    initial = copy.deepcopy(trainer.model), copy.deepcopy(trainer.vgg)
    streams, draws = RngStreams(0, "cpu"), []

    class Recorded:
        def normal(self, stream, shape):
            draws.append(streams.normal(stream, shape))
            return draws[-1]

    images = torch.from_numpy(np.random.default_rng(0).random((args.batch,) + tuple(args.image) + (3,), np.float32))
    records = []
    for _ in range(args.steps):
        trainer.model.train()
        trainer.optimizer.zero_grad()
        loss, metrics, out = trainer.compute_losses(images, Recorded())
        loss.backward()
        trainer.optimizer.step()
        records.append({**{k: float(v.detach()) for k, v in metrics.items()},
                        "max_log_variance": level_summary([x.detach().float().numpy()
                                                           for x in out["encoded_observations"]])})
    return initial, records, [d.numpy() for d in draws], images.numpy()


def jax_trajectory(args, initial, draws, images):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import dataclasses

    import jax.numpy as jnp

    from playableenvironments_tpu import config as jax_config
    from playableenvironments_tpu.eval import perceptual as jperceptual
    from playableenvironments_tpu.models.autoencoder import MultiresAutoencoder as JaxAutoencoder
    from playableenvironments_tpu.train import trainer_autoencoder as jtrainer
    from playableenvironments_tpu.train.state import create_train_state, make_optimizer

    cfg = jax_config.AutoencoderConfig(variant=args.variant, compute_dtype=args.dtype)
    training = jtrainer.AutoencoderTrainingConfig(perceptual_lambda=0.1, kl_lambda=5e-6)
    # Built without the perceptual term (which would initialize VGG19 on
    # its own weights); the port's VGG weights are set afterwards.
    trainer = jtrainer.AutoencoderTrainer(cfg, dataclasses.replace(training, perceptual_lambda=0.0))
    trainer.cfg = training
    example = jnp.zeros((1,) + tuple(args.image) + (3,))
    ae_shapes = jax.eval_shape(lambda k: JaxAutoencoder(cfg).init(k, example, train=False), jax.random.PRNGKey(0))
    vgg = jperceptual.VGGFeatures(jperceptual.VGG19_PLAN, jperceptual.VGG19_CUTS)
    vgg_shapes = jax.eval_shape(lambda k: vgg.init(k, example), jax.random.PRNGKey(0))
    model, vgg_module = initial
    vgg_variables = {"params": flax_tree(vgg_module, vgg_shapes["params"])}
    params = flax_tree(model, ae_shapes["params"])
    batch_stats = flax_tree(model, ae_shapes["batch_stats"])
    tx = make_optimizer(training.learning_rate, training.lr_gamma, training.lr_decay_iterations)
    state = create_train_state(params, batch_stats, tx)
    images = jnp.asarray(images)
    levels = len(cfg.downsampling_layers_count)

    @jax.jit
    def step(state, noises, images, vgg_variables):
        # Images and VGG weights are arguments, not constants XLA would fold.
        trainer.vgg_variables = vgg_variables
        queue = list(noises)
        original = jax.random.normal

        def replayed(key, shape, dtype=jnp.float32):
            value = queue.pop(0)
            assert tuple(value.shape) == tuple(shape), (value.shape, shape)
            return value.astype(dtype)

        jax.random.normal = replayed
        try:
            def loss_fn(p):
                return trainer.compute_losses(p, state.batch_stats, images, jax.random.PRNGKey(0))

            (_, (metrics, new_stats, out)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        finally:
            jax.random.normal = original
        return state.apply_gradients(grads).replace(batch_stats=new_stats), metrics, out["encoded_observations"]

    records = []
    for i in range(args.steps):
        state, metrics, encoded = step(state, [jnp.asarray(d) for d in draws[i * levels:(i + 1) * levels]], images,
                                       vgg_variables)
        records.append({**{k: float(v) for k, v in jax.device_get(metrics).items()},
                        "max_log_variance": level_summary(jax.device_get(encoded))})
    return records


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--image", type=int, nargs=2, default=(72, 128))
    parser.add_argument("--steps", type=int, default=7)
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--variant", default="v8", choices=("v8", "v9"))
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    initial, port, draws, images = port_trajectory(args)
    ref = jax_trajectory(args, initial, draws, images)
    print(f"{'step':>4} {'port loss':>14} {'JAX loss':>14} {'port KL':>14} {'JAX KL':>14}  largest log variance a level "
          "(port | JAX)")
    for i, (p, j) in enumerate(zip(port, ref)):
        print(f"{i + 1:>4} {p['loss']:>14.6g} {j['loss']:>14.6g} {p['kl_loss']:>14.6g} {j['kl_loss']:>14.6g}  "
              f"{[round(v, 3) for v in p['max_log_variance']]} | {[round(v, 3) for v in j['max_log_variance']]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "port": port, "jax": ref}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
