"""Converters from the published metric-network weight layouts into the
port's modules.

Port of playableenvironments_tpu/compat/metric_weights.py, under its
function names. The published files a user would drop in:

- InceptionV3: a torchvision / pytorch_fid state dict
  (`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch5x5_1.bn.running_var`, ...)
  -> eval/inception_v3.py::InceptionV3Features (its branches are named
  `b0`, `b1a`, ...);
- I3D: the tfhub Kinetics-400 RGB variables
  (`RGB/inception_i3d/Mixed_3b/Branch_1/Conv3d_0b_3x3/conv_3d/w`, ...)
  -> eval/i3d.py::I3D, kernels (t, h, w, in, out) -> (out, in, t, h, w),
  the 1x1x1 `Logits` convolution -> the `logits` Linear;
- LPIPS: the `lpips` package's linear heads (`lin0.model.1.weight`, ...)
  and a torchvision VGG16 backbone -> eval/perceptual.py::LPIPS.

Each converter returns a state dict of the port's module (tensors on the
CPU) and is strict: a missing key raises KeyError naming it and the layout
expected, so a wrong file fails loudly instead of giving metrics of random
weights; InceptionV3 also refuses keys it does not consume. The `load_*`
functions read the files and convert them; `load_converted` puts a
converted state dict into a module, strictly (every entry of the module
covered, every shape checked).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from playableenvironments_tpu_torch.eval.perceptual import VGG16_PLAN


def _tensor(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def load_converted(net: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """A converted state dict into `net`, strictly: the same entries, each
    of its shape. :return: the network."""
    own = net.state_dict()
    if set(own) != set(state):
        raise KeyError(f"converted state and {type(net).__name__} differ: missing "
                       f"{sorted(set(own) - set(state))[:5]}, unknown {sorted(set(state) - set(own))[:5]}")
    net.load_state_dict(state, strict=True)
    return net


def read_torch_state_dict(path: str) -> Mapping:
    """A torch checkpoint file's state dict (a saved module gives its own)."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    return state.state_dict() if hasattr(state, "state_dict") else state


# ---------------------------------------------------------------------------
# InceptionV3 (torchvision / pytorch_fid layout)
# ---------------------------------------------------------------------------

# torch branch name -> the port's module name, per inception block type
# (eval/inception_v3.py InceptionA..E).
_INCEPTION_BRANCHES = {
    "A": {"branch1x1": "b0", "branch5x5_1": "b1a", "branch5x5_2": "b1b", "branch3x3dbl_1": "b2a",
          "branch3x3dbl_2": "b2b", "branch3x3dbl_3": "b2c", "branch_pool": "b3"},
    "B": {"branch3x3": "b0", "branch3x3dbl_1": "b1a", "branch3x3dbl_2": "b1b", "branch3x3dbl_3": "b1c"},
    "C": {"branch1x1": "b0", "branch7x7_1": "b1a", "branch7x7_2": "b1b", "branch7x7_3": "b1c",
          "branch7x7dbl_1": "b2a", "branch7x7dbl_2": "b2b", "branch7x7dbl_3": "b2c", "branch7x7dbl_4": "b2d",
          "branch7x7dbl_5": "b2e", "branch_pool": "b3"},
    "D": {"branch3x3_1": "b0a", "branch3x3_2": "b0b", "branch7x7x3_1": "b1a", "branch7x7x3_2": "b1b",
          "branch7x7x3_3": "b1c", "branch7x7x3_4": "b1d"},
    "E": {"branch1x1": "b0", "branch3x3_1": "b1a", "branch3x3_2a": "b1b", "branch3x3_2b": "b1c",
          "branch3x3dbl_1": "b2a", "branch3x3dbl_2": "b2b", "branch3x3dbl_3a": "b2c", "branch3x3dbl_3b": "b2d",
          "branch_pool": "b3"},
}
_INCEPTION_BLOCKS = {
    "Mixed_5b": "A", "Mixed_5c": "A", "Mixed_5d": "A", "Mixed_6a": "B", "Mixed_6b": "C", "Mixed_6c": "C",
    "Mixed_6d": "C", "Mixed_6e": "C", "Mixed_7a": "D", "Mixed_7b": "E", "Mixed_7c": "E",
}
_INCEPTION_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3")
# The entries of a BasicConv, under the same names in both layouts.
_BASIC_CONV = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")


def convert_torch_inception_state_dict(state: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision/pytorch_fid InceptionV3 state dict -> the state dict of
    InceptionV3Features. The classifier (`fc.*`), the training-only
    AuxLogits and the batch norms' `num_batches_tracked` are dropped (FID
    reads the final pool); any other key the network does not consume
    raises, so that a variant with extra branches is not silently read as
    another network."""
    prefixes = [(name, name) for name in _INCEPTION_STEM] + [
        (f"{block}.{branch}", f"{block}.{ours}")
        for block, kind in _INCEPTION_BLOCKS.items() for branch, ours in _INCEPTION_BRANCHES[kind].items()]
    out, consumed = {}, set()
    for torch_prefix, prefix in prefixes:
        for entry in _BASIC_CONV:
            key = f"{torch_prefix}.{entry}"
            if key not in state:
                raise KeyError(f"InceptionV3 state_dict is missing '{key}': expected the torchvision/pytorch_fid "
                               "layout (Conv2d_1a_3x3.conv.weight, ...)")
            out[f"{prefix}.{entry}"] = _tensor(state[key])
            consumed.add(key)
        consumed.add(f"{torch_prefix}.bn.num_batches_tracked")
    leftovers = [k for k in state if k not in consumed and not k.startswith(("fc.", "AuxLogits."))]
    if leftovers:
        raise KeyError(f"unrecognized InceptionV3 keys (first 5): {sorted(leftovers)[:5]}")
    return out


def load_torch_inception_weights(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision/pytorch_fid InceptionV3 checkpoint file, converted."""
    return convert_torch_inception_state_dict(read_torch_state_dict(path))


# ---------------------------------------------------------------------------
# I3D (tfhub Kinetics-400 RGB layout)
# ---------------------------------------------------------------------------

_I3D_STEM = ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")
_I3D_BLOCKS = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f", "Mixed_5b",
               "Mixed_5c")
# tfhub branch unit -> the port's module name (eval/i3d.py InceptionBlock3D).
_I3D_BRANCHES = {
    "Branch_0/Conv3d_0a_1x1": "b0", "Branch_1/Conv3d_0a_1x1": "b1a", "Branch_1/Conv3d_0b_3x3": "b1b",
    "Branch_2/Conv3d_0a_1x1": "b2a", "Branch_2/Conv3d_0b_3x3": "b2b", "Branch_3/Conv3d_0b_1x1": "b3",
}
_I3D_PREFIX = "RGB/inception_i3d/"


def _i3d_variable(variables: Mapping, key: str) -> torch.Tensor:
    try:
        return _tensor(variables[key])
    except KeyError:
        raise KeyError(f"I3D variables are missing '{key}': expected the tfhub Kinetics-400 RGB layout "
                       "(RGB/inception_i3d/.../conv_3d/w, ...)") from None


def convert_tfhub_i3d_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A tfhub I3D variable map -> the state dict of I3D: each unit's
    `conv_3d/w` (t, h, w, in, out) -> `conv.weight` (out, in, t, h, w), its
    `batch_norm` beta and moving statistics -> `bn.bias`,
    `bn.running_mean`, `bn.running_var` (the released graph's batch norms
    have no gamma); the 1x1x1 Logits convolution -> `logits`."""
    units = [(_I3D_PREFIX + name, name) for name in _I3D_STEM] + [
        (f"{_I3D_PREFIX}{block}/{branch}", f"{block}.{ours}") for block in _I3D_BLOCKS
        for branch, ours in _I3D_BRANCHES.items()]
    out = {}
    for tf_prefix, prefix in units:
        out[f"{prefix}.conv.weight"] = _i3d_variable(variables, f"{tf_prefix}/conv_3d/w").permute(4, 3, 0, 1, 2)
        out[f"{prefix}.bn.bias"] = _i3d_variable(variables, f"{tf_prefix}/batch_norm/beta").reshape(-1)
        out[f"{prefix}.bn.running_mean"] = _i3d_variable(variables,
                                                         f"{tf_prefix}/batch_norm/moving_mean").reshape(-1)
        out[f"{prefix}.bn.running_var"] = _i3d_variable(variables,
                                                        f"{tf_prefix}/batch_norm/moving_variance").reshape(-1)
    weight = _i3d_variable(variables, f"{_I3D_PREFIX}Logits/Conv3d_0c_1x1/conv_3d/w")
    out["logits.weight"] = weight.reshape(weight.shape[-2], weight.shape[-1]).t()
    out["logits.bias"] = _i3d_variable(variables, f"{_I3D_PREFIX}Logits/Conv3d_0c_1x1/conv_3d/b").reshape(-1)
    return {k: v.contiguous() for k, v in out.items()}


def load_tfhub_i3d_weights(path: str) -> Dict[str, torch.Tensor]:
    """An npz archive of the tfhub variable map (the hub module's variables
    under their original names), converted."""
    with np.load(path) as archive:
        return convert_tfhub_i3d_variables({k: archive[k] for k in archive.files})


# ---------------------------------------------------------------------------
# LPIPS (lpips package layout)
# ---------------------------------------------------------------------------


def convert_lpips_state_dict(lins_state: Mapping, vgg16_state: Mapping) -> Dict[str, torch.Tensor]:
    """The lpips package's `vgg.pth` heads (`lin{i}.model.1.weight`,
    (1, C, 1, 1)) and a torchvision VGG16 `features.N` state dict -> the
    state dict of LPIPS (`backbone.conv{block}_{i}`, `lin_{i}` (C,))."""
    out: Dict[str, torch.Tensor] = {}
    torch_idx = 0
    for block_idx, widths in enumerate(VGG16_PLAN):
        for conv_idx in range(len(widths)):
            for leaf in ("weight", "bias"):
                key = f"features.{torch_idx}.{leaf}"
                if key not in vgg16_state:
                    raise KeyError(f"VGG16 state_dict is missing '{key}': expected the torchvision layout "
                                   "(features.0.weight, ...)")
                out[f"backbone.conv{block_idx}_{conv_idx}.{leaf}"] = _tensor(vgg16_state[key])
            torch_idx += 2  # conv + ReLU
        torch_idx += 1  # the pool
    for idx in range(5):
        key = f"lin{idx}.model.1.weight"
        if key not in lins_state:
            raise KeyError(f"LPIPS state_dict is missing '{key}': expected the lpips package layout "
                           "(lin0.model.1.weight, ...)")
        out[f"lin_{idx}"] = _tensor(lins_state[key]).reshape(-1)
    return out


def load_torch_lpips_weights(lins_path: str, vgg16_path: str) -> Dict[str, torch.Tensor]:
    """The lpips package's heads and a torchvision VGG16 checkpoint, converted."""
    return convert_lpips_state_dict(torch.load(lins_path, map_location="cpu", weights_only=False),
                                    read_torch_state_dict(vgg16_path))
