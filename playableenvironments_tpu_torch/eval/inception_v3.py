"""InceptionV3 image network, the FID embedding backbone.

Port of playableenvironments_tpu/eval/inception_v3.py: torchvision's
InceptionV3 geometry up to the 2048-d final average pool, with pytorch_fid's
two FID patches (in-block average pools exclude the padding from their
divisor; Mixed_7c's pool branch max-pools). Stem convolutions and the
stride-2 reductions are VALID, in-block convolutions SAME (odd kernels,
stride 1: symmetric padding). Every convolution is followed by a batch norm
with epsilon 1e-3 and a ReLU. Modules are named after the flax tree
(`Mixed_5b.b1a.conv`, `.bn`), so compat/from_flax.py::load_inception loads
JAX variables by name, and `load_inception_params_npz` reads the same
archive the JAX package does. No weights ship with the repo.

As the JAX network's `precision="highest"`, the convolutions run in IEEE
f32 on a card (cuDNN's TF32 off inside the forward only), so that FID
embeddings do not depend on the device.

Input: (B, H, W, 3) in [0, 1]; `inception_image_embedder` resizes to
299x299 (bilinear, antialiased when it shrinks, as jax.image.resize).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.models.layers import BatchNorm

Kernel = Union[int, Tuple[int, int]]


class BasicConv(nn.Module):
    """Conv (no bias) -> batch norm (epsilon 1e-3) -> ReLU."""

    def __init__(self, in_features: int, features: int, kernel: Kernel = 1, strides: int = 1,
                 padding: str = "SAME", device=None):
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        if padding == "SAME":
            if strides != 1 or kernel[0] % 2 == 0 or kernel[1] % 2 == 0:
                raise ValueError("SAME padding is symmetric only for odd kernels at stride 1")
            pad = (kernel[0] // 2, kernel[1] // 2)
        else:
            pad = (0, 0)
        self.conv = nn.Conv2d(in_features, features, kernel, stride=strides, padding=pad, bias=False, device=device)
        self.bn = BatchNorm(features, epsilon=1e-3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), False))  # running statistics: the embedder is never trained


def _fid_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/1 SAME average pool excluding the padding from the divisor."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_features: int, pool_features: int, device=None):
        super().__init__()
        self.b0 = BasicConv(in_features, 64, device=device)
        self.b1a = BasicConv(in_features, 48, device=device)
        self.b1b = BasicConv(48, 64, 5, device=device)
        self.b2a = BasicConv(in_features, 64, device=device)
        self.b2b = BasicConv(64, 96, 3, device=device)
        self.b2c = BasicConv(96, 96, 3, device=device)
        self.b3 = BasicConv(in_features, pool_features, device=device)
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1b(self.b1a(x))
        b2 = self.b2c(self.b2b(self.b2a(x)))
        b3 = self.b3(_fid_avg_pool(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_features: int, device=None):
        super().__init__()
        self.b0 = BasicConv(in_features, 384, 3, strides=2, padding="VALID", device=device)
        self.b1a = BasicConv(in_features, 64, device=device)
        self.b1b = BasicConv(64, 96, 3, device=device)
        self.b1c = BasicConv(96, 96, 3, strides=2, padding="VALID", device=device)
        self.out_features = 384 + 96 + in_features

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1c(self.b1b(self.b1a(x)))
        return torch.cat([b0, b1, _max_pool_valid(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_features: int, channels_7x7: int, device=None):
        super().__init__()
        c7 = channels_7x7
        self.b0 = BasicConv(in_features, 192, device=device)
        self.b1a = BasicConv(in_features, c7, device=device)
        self.b1b = BasicConv(c7, c7, (1, 7), device=device)
        self.b1c = BasicConv(c7, 192, (7, 1), device=device)
        self.b2a = BasicConv(in_features, c7, device=device)
        self.b2b = BasicConv(c7, c7, (7, 1), device=device)
        self.b2c = BasicConv(c7, c7, (1, 7), device=device)
        self.b2d = BasicConv(c7, c7, (7, 1), device=device)
        self.b2e = BasicConv(c7, 192, (1, 7), device=device)
        self.b3 = BasicConv(in_features, 192, device=device)
        self.out_features = 4 * 192

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1c(self.b1b(self.b1a(x)))
        b2 = self.b2a(x)
        for layer in (self.b2b, self.b2c, self.b2d, self.b2e):
            b2 = layer(b2)
        b3 = self.b3(_fid_avg_pool(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_features: int, device=None):
        super().__init__()
        self.b0a = BasicConv(in_features, 192, device=device)
        self.b0b = BasicConv(192, 320, 3, strides=2, padding="VALID", device=device)
        self.b1a = BasicConv(in_features, 192, device=device)
        self.b1b = BasicConv(192, 192, (1, 7), device=device)
        self.b1c = BasicConv(192, 192, (7, 1), device=device)
        self.b1d = BasicConv(192, 192, 3, strides=2, padding="VALID", device=device)
        self.out_features = 320 + 192 + in_features

    def forward(self, x):
        b0 = self.b0b(self.b0a(x))
        b1 = self.b1a(x)
        for layer in (self.b1b, self.b1c, self.b1d):
            b1 = layer(b1)
        return torch.cat([b0, b1, _max_pool_valid(x)], dim=1)


class InceptionE(nn.Module):
    """The FID network's last E block (Mixed_7c) max-pools its pool branch
    where every other block average-pools."""

    def __init__(self, in_features: int, pool_max: bool = False, device=None):
        super().__init__()
        self.pool_max = pool_max
        self.b0 = BasicConv(in_features, 320, device=device)
        self.b1a = BasicConv(in_features, 384, device=device)
        self.b1b = BasicConv(384, 384, (1, 3), device=device)
        self.b1c = BasicConv(384, 384, (3, 1), device=device)
        self.b2a = BasicConv(in_features, 448, device=device)
        self.b2b = BasicConv(448, 384, 3, device=device)
        self.b2c = BasicConv(384, 384, (1, 3), device=device)
        self.b2d = BasicConv(384, 384, (3, 1), device=device)
        self.b3 = BasicConv(in_features, 192, device=device)
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1a(x)
        b1 = torch.cat([self.b1b(b1), self.b1c(b1)], dim=1)
        b2 = self.b2b(self.b2a(x))
        b2 = torch.cat([self.b2c(b2), self.b2d(b2)], dim=1)
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if self.pool_max else _fid_avg_pool(x)
        b3 = self.b3(pooled)
        return torch.cat([b0, b1, b2, b3], dim=1)


def ieee_convolutions(device: torch.device):
    """cuDNN without TF32 for the region (the JAX network's
    precision="highest"), its other switches as they are."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=False)


class InceptionV3Features(nn.Module):
    """InceptionV3 up to the 2048-d global average pool (the FID layer)."""

    def __init__(self, device=None):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, strides=2, padding="VALID", device=device)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, padding="VALID", device=device)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, device=device)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, device=device)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, padding="VALID", device=device)
        blocks = (("Mixed_5b", lambda c: InceptionA(c, 32, device)), ("Mixed_5c", lambda c: InceptionA(c, 64, device)),
                  ("Mixed_5d", lambda c: InceptionA(c, 64, device)), ("Mixed_6a", lambda c: InceptionB(c, device)),
                  ("Mixed_6b", lambda c: InceptionC(c, 128, device)), ("Mixed_6c", lambda c: InceptionC(c, 160, device)),
                  ("Mixed_6d", lambda c: InceptionC(c, 160, device)), ("Mixed_6e", lambda c: InceptionC(c, 192, device)),
                  ("Mixed_7a", lambda c: InceptionD(c, device)), ("Mixed_7b", lambda c: InceptionE(c, False, device)),
                  ("Mixed_7c", lambda c: InceptionE(c, True, device)))
        features = 192
        self.block_names = []
        for name, make in blocks:
            block = make(features)
            self.add_module(name, block)
            self.block_names.append(name)
            features = block.out_features
        self.out_features = features

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """:param images: (B, H, W, 3) in [0, 1]. :return: (B, 2048)."""
        with ieee_convolutions(images.device):
            x = (images * 2.0 - 1.0).permute(0, 3, 1, 2)  # [0, 1] -> [-1, 1] (pytorch_fid's convention)
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = _max_pool_valid(x)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = _max_pool_valid(x)
            for name in self.block_names:
                x = getattr(self, name)(x)
            return torch.mean(x, dim=(2, 3))


def load_inception_params_npz(path: str) -> Dict:
    """npz archive with flax-path keys ('Mixed_5b/b1a/conv/kernel', ...) ->
    a variables dict of NumPy arrays ({"params": ..., "batch_stats": ...}),
    as the JAX package reads it: torch (out, in, h, w) conv kernels are
    transposed to flax's HWIO."""
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
            if leaf == "kernel" and value.ndim == 4 and value.shape[0] > value.shape[-2]:
                value = np.transpose(value, (2, 3, 1, 0))  # torch -> flax
            insert(batch_stats if leaf in ("mean", "var") else params, keys, value)
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return variables


def resize_bilinear(images: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, size[0], size[1], C), jax.image.resize's
    "bilinear": half-pixel centres, a triangle filter widened by the factor
    (antialiased) along an axis that shrinks."""
    x = images.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def inception_image_embedder(net: InceptionV3Features, resize_to: int = 299):
    """A FID embedding function: images (B, H, W, 3) NumPy in [0, 1] ->
    (B, 2048), EMBED_CHUNK images a forward pass on the network's device."""
    from playableenvironments_tpu_torch.eval.distribution_metrics import embed_in_chunks

    device = next(net.parameters()).device

    def forward(images):
        if tuple(images.shape[1:3]) != (resize_to, resize_to):
            images = resize_bilinear(images, (resize_to, resize_to))
        return net(images)

    def fn(images: np.ndarray) -> np.ndarray:
        return embed_in_chunks(forward, images, device).cpu().numpy()

    return fn
