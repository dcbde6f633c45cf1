"""Carry the JAX package's flax variables into the port's modules.

The inputs are nested dicts of numpy arrays (e.g. `jax.device_get` of a
variables tree); nothing here imports JAX. Leaves map by name:
- Dense `kernel` (in, out) -> Linear `weight` (out, in);
- Conv `kernel` HWIO -> Conv2d `weight` OIHW, and (k, in, out) -> Conv1d
  `weight` (out, in, k);
- BatchNorm `scale`/`bias` -> `weight`/`bias`, batch_stats `mean`/`var` ->
  `running_mean`/`running_var` (the AdaIN running statistics keep their
  names `norm.mean`/`norm.var`);
- LSTM gates keep their flax names (ii/if/ig/io without bias, hi/hf/hg/ho
  with), as do plain parameters such as `initial_hidden_0`.
Every parameter and buffer of the target must be covered, and every leaf
must land on one of the same shape. `load_npz` reads the `.npz` that
scripts/export_flax_checkpoint.py writes from a JAX checkpoint into the
nested mapping these loaders take.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_RENAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _leaves(value, path + ".")
        else:
            yield path, np.asarray(value)


def load_flax_tree(module: nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None) -> None:
    """Load one flax subtree (params, and batch_stats where it has them)
    into `module`, strictly: raises on a missing, unknown or misshapen leaf."""
    state = module.state_dict()
    loaded = {}
    for tree in (params, batch_stats or {}):
        for path, value in _leaves(tree):
            head, _, leaf = path.rpartition(".")
            key = path if path in state else f"{head}.{_RENAMES.get(leaf, leaf)}".lstrip(".")
            if key not in state:
                raise KeyError(f"flax leaf {path!r} has no counterpart in {type(module).__name__}")
            tensor = torch.from_numpy(np.array(value, dtype=np.float32))
            if leaf == "kernel":
                tensor = {2: lambda x: x.t(), 3: lambda x: x.permute(2, 1, 0),
                          4: lambda x: x.permute(3, 2, 0, 1)}[tensor.dim()](tensor)
            if tuple(tensor.shape) != tuple(state[key].shape):
                raise ValueError(
                    f"flax leaf {path!r} has shape {tuple(tensor.shape)}, "
                    f"{key!r} needs {tuple(state[key].shape)}"
                )
            loaded[key] = tensor
    missing = [k for k in state if k not in loaded]
    if missing:
        raise KeyError(f"no flax leaf for {missing}")
    state.update(loaded)
    module.load_state_dict(state)


def load_environment(composer, autoencoder, variables: Mapping) -> None:
    """EnvironmentModel variables (`params`/`batch_stats` with `composer`
    and `autoencoder` subtrees) -> SceneComposer and, if given, the
    MultiresAutoencoder's decoder (encoder leaves are not read)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    load_flax_tree(composer, params["composer"], stats.get("composer"))
    if autoencoder is not None:
        load_flax_tree(
            autoencoder.decoder,
            params["autoencoder"]["decoder"],
            stats.get("autoencoder", {}).get("decoder"),
        )


def load_environment_model(model, variables: Mapping) -> list:
    """EnvironmentModel variables -> render.environment_model.EnvironmentModel:
    `composer` (AdaIN and skybox NeRFs, benders, the separate fine fields
    `object_model_fine_i`), every `object_encoder_i`, every
    `parameters_encoder_i` (the learned pose CNNs) and, where the model has
    them, the full `autoencoder` (encoder and decoder) and the per-frame
    `camera_offsets` table, params and batch_stats, strictly. Subtrees the
    model has no counterpart for (camera offsets, the autoencoder) are left
    unread and named in the returned list; any other top-level subtree
    raises.

    :return: sorted names of the skipped subtrees.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    expected = {"composer"} | {n for n, _ in model.named_children()
                               if n.startswith(("object_encoder_", "parameters_encoder_"))
                               or n in ("autoencoder", "camera_offsets")}
    skippable = {"autoencoder", "camera_offsets"}
    unknown = set(params) - expected - skippable
    if unknown:
        raise KeyError(f"flax subtrees {sorted(unknown)} have no counterpart in EnvironmentModel")
    missing = expected - set(params)
    if missing:
        raise KeyError(f"no flax subtree for {sorted(missing)}")
    for name in sorted(expected):
        load_flax_tree(getattr(model, name), params[name], stats.get(name))
    return sorted(set(params) & skippable - expected)


def _spectral_norm_stats(stats: Mapping) -> dict:
    """flax SpectralNorm state {"SpectralNorm_k": {"{layer}/kernel/u": ..,
    "{layer}/kernel/sigma": ..}} -> the discriminator's buffers
    {"{layer}_u": .., "{layer}_sigma": ..}."""
    out = {}
    for wrapper in stats.values():
        for path, value in wrapper.items():
            layer, _, leaf = path.split("/")
            out[f"{layer}_{leaf}"] = value
    return out


def load_playable(playable_model, variables: Mapping) -> list:
    """PlayableEnvironmentModel variables -> render.playable_model.
    PlayableEnvironmentModel, strictly per subtree: every animation model's
    `dynamics_network`; its `action_network` (Dense layers, BN scale, bias
    and running statistics) where the flax tree has one (a tree initialized
    through the play loop's dynamics step has none); every discriminator
    (Conv kernels, the Dense head, the spectral norms' `u`/`sigma` from
    batch_stats) when the model has them. Unknown subtrees raise.

    :return: sorted names of the port's submodules left at their seeded
        initialization (action networks absent from the tree).
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    children = dict(playable_model.named_children())
    unknown = set(params) - set(children)
    if unknown:
        raise KeyError(f"flax subtrees {sorted(unknown)} have no counterpart in PlayableEnvironmentModel")
    left = []
    for name, module in children.items():
        if name.startswith("animation_model_"):
            tree, tree_stats = params[name], stats.get(name, {})
            extra = set(tree) - {"dynamics_network", "action_network"}
            if extra:
                raise KeyError(f"flax subtrees {sorted(extra)} of {name} have no counterpart")
            load_flax_tree(module.dynamics_network, tree["dynamics_network"])
            if "action_network" in tree:
                load_flax_tree(module.action_network, tree["action_network"], tree_stats.get("action_network"))
            else:
                left.append(f"{name}.action_network")
        elif name.startswith("discriminator_"):
            if name not in params:
                raise KeyError(f"no flax subtree for {name}")
            load_flax_tree(module, params[name], _spectral_norm_stats(stats.get(name, {})))
    return sorted(left)


def load_playable_extra(trainer, extra: Mapping) -> None:
    """The JAX TrainState's `extra` of a phase-3 state -> the trainer's
    per-animation-model centroids and MI matrices (other entries, such as
    the frozen environment and the discriminator's optimizer state, are not
    read)."""
    count = len(trainer.scene_animation_configs())
    device = next(trainer.playable_model.parameters()).device
    as_tensor = lambda x: torch.from_numpy(np.array(x, dtype=np.float32)).to(device)  # noqa: E731
    trainer.centroids = [as_tensor(extra["centroids"][str(i)]) for i in range(count)]
    trainer.mi_matrices = [as_tensor(extra["mi_matrices"][str(i)]) for i in range(count)]


def load_autoencoder(autoencoder, variables: Mapping) -> None:
    """MultiresAutoencoder variables (a phase-1 TrainState's params and
    batch_stats: `encoder` and `decoder` subtrees) -> the port's
    MultiresAutoencoder, strictly."""
    load_flax_tree(autoencoder, variables["params"], variables.get("batch_stats"))


def load_vgg(net, variables: Mapping) -> None:
    """VGGFeatures variables (`conv{block}_{i}` kernels HWIO, biases) ->
    eval.perceptual.VGGFeatures (OIHW), strictly."""
    load_flax_tree(net, variables["params"])


def load_inception(net, variables: Mapping) -> None:
    """InceptionV3Features variables (`Mixed_5b/b1a/conv/kernel` HWIO,
    `.../bn/scale|bias`, batch_stats `.../bn/mean|var`; e.g.
    eval.inception_v3.load_inception_params_npz of an archive) ->
    eval.inception_v3.InceptionV3Features, strictly."""
    load_flax_tree(net, variables["params"], variables.get("batch_stats"))


def _unescape_key(segment: str) -> str:
    """One segment of an exported key: "%2F" stands for "/" inside a flax
    name (the spectral norms' "layer/kernel/u"), "%25" for "%"."""
    return segment.replace("%2F", "/").replace("%25", "%")


def load_npz(path: str) -> Tuple[dict, int]:
    """A JAX checkpoint exported by scripts/export_flax_checkpoint.py:
    (variables {"params": ..., "batch_stats": ...} as nested dicts of numpy
    arrays, the step). Keys are "/"-joined paths of escaped names."""
    variables: dict = {"params": {}, "batch_stats": {}}
    step = -1
    with np.load(path) as data:
        for key in data.files:
            if key == "step":
                step = int(data[key])
                continue
            *heads, leaf = [_unescape_key(segment) for segment in key.split("/")]
            if heads[0] not in variables:
                raise KeyError(f"{path}: entry {key!r} is neither params nor batch_stats")
            node = variables
            for head in heads:
                node = node.setdefault(head, {})
            node[leaf] = data[key]
    return variables, step
