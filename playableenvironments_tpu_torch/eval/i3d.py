"""I3D (the inflated Inception-V1 of Carreira and Zisserman, "Quo Vadis",
CVPR 2017; the Kinetics-400 RGB stream): the FVD embedding backbone.

Port of playableenvironments_tpu/eval/i3d.py: `Unit3D` (a 3D convolution,
then a batch norm without scale at epsilon 1e-3, the released graph's, and
a ReLU), `InceptionBlock3D` (1x1 / 1x1 -> 3x3 / 1x1 -> 3x3 / max pool ->
1x1), `I3D` with `INCEPTION_SPECS` (400 logits from the global
spatiotemporal mean), `load_i3d_params_npz` and `i3d_video_embedder`. No
weights ship with the repo: the network runs on the weights it is given
(compat/from_flax.py::load_i3d, compat/metric_weights.py's tfhub
converter).

SAME windows are padded as XLA pads them (ops/padding.py::pad_same): the
stride-2 stem and the stride-2 max pools pad less before than after on an
even side, the pools with -inf. As the JAX network's precision="highest",
every convolution and the Dense run in IEEE f32 on a card (cuDNN's TF32 off
inside the forward, as eval/inception_v3.py does; float32 matmuls are IEEE
by PyTorch's default): TF32 would move the 57 units' embeddings past any
golden tolerance.

Input: (B, T, H, W, 3) videos in [0, 1], T >= 9, 224x224 canonical (any
side >= 32 works), rescaled to [-1, 1]; output (B, 400) logits.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.eval.inception_v3 import ieee_convolutions, resize_bilinear
from playableenvironments_tpu_torch.ops.padding import pad_same


def _triple(value) -> Tuple[int, int, int]:
    return (value,) * 3 if isinstance(value, int) else tuple(value)


class BatchNormNoScale(nn.Module):
    """flax nn.BatchNorm(use_scale=False) on running statistics over NCTHW
    channels: (x - mean) / sqrt(var + epsilon) + bias. The embedder is
    never trained, so there are no batch statistics."""

    def __init__(self, features: int, epsilon: float = 1e-3, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1, 1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.epsilon)
        return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class Unit3D(nn.Module):
    """SAME Conv3D (no bias) -> batch norm without scale -> ReLU."""

    def __init__(self, in_features: int, features: int, kernel=1, strides=1, device=None):
        super().__init__()
        self.conv = nn.Conv3d(in_features, features, _triple(kernel), stride=_triple(strides), bias=False,
                              device=device)
        self.bn = BatchNormNoScale(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x, self.conv.kernel_size, self.conv.stride)
        return torch.relu(self.bn(F.conv3d(x, self.conv.weight, None, self.conv.stride)))


def max_pool_same(x: torch.Tensor, window: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """flax nn.max_pool(padding="SAME") of NCTHW: -inf padding as XLA
    places it, then an unpadded pool."""
    return F.max_pool3d(pad_same(x, window, strides, value=float("-inf")), window, strides)


class InceptionBlock3D(nn.Module):
    """Four branches concatenated over channels: 1x1 (b0), 1x1 -> 3x3x3
    (b1a, b1b), 1x1 -> 3x3x3 (b2a, b2b), a 3x3x3/1 max pool -> 1x1 (b3)."""

    def __init__(self, in_features: int, b0: int, b1: Tuple[int, int], b2: Tuple[int, int], b3: int, device=None):
        super().__init__()
        self.b0 = Unit3D(in_features, b0, device=device)
        self.b1a = Unit3D(in_features, b1[0], device=device)
        self.b1b = Unit3D(b1[0], b1[1], 3, device=device)
        self.b2a = Unit3D(in_features, b2[0], device=device)
        self.b2b = Unit3D(b2[0], b2[1], 3, device=device)
        self.b3 = Unit3D(in_features, b3, device=device)
        self.out_features = b0 + b1[1] + b2[1] + b3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3(max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


# (name, spec) of the I3D paper and its released checkpoint.
INCEPTION_SPECS = (
    ("Mixed_3b", dict(b0=64, b1=(96, 128), b2=(16, 32), b3=32)),
    ("Mixed_3c", dict(b0=128, b1=(128, 192), b2=(32, 96), b3=64)),
    ("Mixed_4b", dict(b0=192, b1=(96, 208), b2=(16, 48), b3=64)),
    ("Mixed_4c", dict(b0=160, b1=(112, 224), b2=(24, 64), b3=64)),
    ("Mixed_4d", dict(b0=128, b1=(128, 256), b2=(24, 64), b3=64)),
    ("Mixed_4e", dict(b0=112, b1=(144, 288), b2=(32, 64), b3=64)),
    ("Mixed_4f", dict(b0=256, b1=(160, 320), b2=(32, 128), b3=128)),
    ("Mixed_5b", dict(b0=256, b1=(160, 320), b2=(32, 128), b3=128)),
    ("Mixed_5c", dict(b0=384, b1=(192, 384), b2=(48, 128), b3=128)),
)


class I3D(nn.Module):
    """The RGB I3D classifier; `forward` returns the 400 logits."""

    def __init__(self, num_classes: int = 400, device=None):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, 7, 2, device=device)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, device=device)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, 3, device=device)
        features = 192
        self.block_names = []
        for name, spec in INCEPTION_SPECS:
            block = InceptionBlock3D(features, **spec, device=device)
            self.add_module(name, block)
            self.block_names.append(name)
            features = block.out_features
        self.logits = nn.Linear(features, num_classes, device=device)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """:param videos: (B, T, H, W, 3) in [0, 1]. :return: (B, 400)."""
        with ieee_convolutions(videos.device):
            x = (videos * 2.0 - 1.0).permute(0, 4, 1, 2, 3)  # the released checkpoint's [-1, 1]
            x = self.Conv3d_1a_7x7(x)
            x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
            x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
            x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
            for index, name in enumerate(self.block_names):
                if index == 2:
                    x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
                elif index == 7:
                    x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
                x = getattr(self, name)(x)
            return self.logits(torch.mean(x, dim=(2, 3, 4)))


def load_i3d_params_npz(path: str) -> Dict:
    """npz archive with flax-path keys ('Conv3d_1a_7x7/conv/kernel',
    'Mixed_3b/b1a/bn/bias', 'logits/kernel', ...) -> a variables dict of
    NumPy arrays ({"params": ..., "batch_stats": ...}), as the JAX package
    reads it: torch (out, in, t, h, w) conv kernels are transposed to
    (t, h, w, in, out). Load it with compat/from_flax.py::load_i3d."""
    params: Dict = {}
    batch_stats: Dict = {}

    def insert(tree, keys, value):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(value)

    with np.load(path) as archive:
        for full_key in archive.files:
            value = archive[full_key]
            keys = full_key.split("/")
            leaf = keys[-1]
            if leaf == "kernel" and value.ndim == 5 and value.shape[0] > value.shape[-1]:
                value = np.transpose(value, (2, 3, 4, 1, 0))  # torch -> flax
            insert(batch_stats if leaf in ("mean", "var") else params, keys, value)
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return variables


def i3d_video_embedder(net: I3D, resize_to: int = 224):
    """An FVD embedding function: videos (B, T, H, W, 3) NumPy in [0, 1] ->
    (B, 400) NumPy logits, each frame resized to `resize_to` square
    (bilinear, antialiased when it shrinks, as jax.image.resize) on the
    network's device, without autograd."""
    device = next(net.parameters()).device

    @torch.no_grad()
    def fn(videos: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(videos, np.float32)).to(device)
        b, t, h, w, c = x.shape
        if (h, w) != (resize_to, resize_to):
            x = resize_bilinear(x.reshape(b * t, h, w, c), (resize_to, resize_to)).reshape(
                b, t, resize_to, resize_to, c)
        return net(x).cpu().numpy()

    return fn
