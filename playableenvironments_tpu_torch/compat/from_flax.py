"""Carry the JAX package's flax variables into the port's modules.

The inputs are nested dicts of numpy arrays (e.g. `jax.device_get` of a
variables tree); nothing here imports JAX. Leaves map by name:
- Dense `kernel` (in, out) -> Linear `weight` (out, in);
- Conv `kernel` HWIO -> Conv2d `weight` OIHW;
- BatchNorm `scale`/`bias` -> `weight`/`bias`, batch_stats `mean`/`var` ->
  `running_mean`/`running_var` (the AdaIN running statistics keep their
  names `norm.mean`/`norm.var`);
- LSTM gates keep their flax names (ii/if/ig/io without bias, hi/hf/hg/ho
  with), as do plain parameters such as `initial_hidden_0`.
Every parameter and buffer of the target must be covered, and every leaf
must land on one of the same shape.
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
                tensor = tensor.t() if tensor.dim() == 2 else tensor.permute(3, 2, 0, 1)
            if tuple(tensor.shape) != tuple(state[key].shape):
                raise ValueError(
                    f"flax leaf {path!r} has shape {tuple(tensor.shape)}, "
                    f"{key!r} needs {tuple(state[key].shape)}"
                )
            loaded[key] = tensor
    missing = [k for k in state if k not in loaded and not k.endswith("num_batches_tracked")]
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


def load_playable(playable_model, variables: Mapping) -> None:
    """PlayableEnvironmentModel variables -> each animation model's
    `dynamics_network` (other subtrees, such as the action network, belong
    to the phase-3 slice and are not read)."""
    params = variables["params"]
    for name, module in playable_model.named_children():
        if name.startswith("animation_model_"):
            load_flax_tree(module.dynamics_network, params[name]["dynamics_network"])
