"""The VGG feature networks: VGG19 for the perceptual loss, LPIPS's VGG16.

Port of playableenvironments_tpu/eval/perceptual.py: `VGGFeatures`
(ImageNet normalization, SAME 3x3 convolutions with ReLU, 2x2 max pools
between blocks, features after relu1_1 ... relu5_1 for VGG19, after
relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 for LPIPS's VGG16),
`perceptual_loss` (L1 between the features of the ground truth, without
gradient, and of the reconstruction), `LPIPS` (unit-normalized VGG16
feature differences through non-negative 1x1 heads, spatial means summed
over levels), `vgg_cosine_similarity` (the evaluators' per-frame feature
similarity) and `init_vgg19`. No trained weights ship with the repo and
none are downloaded: the networks run on seeded random weights, as the JAX
package's do, unless the user loads a torchvision VGG19 state dict
(`features.N.weight` / `.bias`) with `load_torch_vgg_state_dict` or
`load_torch_vgg_weights`, or LPIPS's with compat/metric_weights.py.

The max pool is torch's: its backward routes each window's gradient to the
first maximum in row-major order, the one-winner rule of the JAX package's
pool (ops/pool.py). Ties are common, since the pools follow ReLUs.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.utils.device import resolve_device

VGG19_PLAN = ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512), (512, 512, 512, 512))
VGG16_PLAN = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
# (block, conv within the block) after whose ReLU a feature is emitted:
# relu1_1, relu2_1, relu3_1, relu4_1, relu5_1; for LPIPS relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3.
VGG19_CUTS = ((0, 0), (1, 0), (2, 0), (3, 0), (4, 0))
VGG16_CUTS = ((0, 1), (1, 1), (2, 2), (3, 2), (4, 2))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGGFeatures(nn.Module):
    """`conv{block}_{i}` 3x3 convolutions of `plan`, up to the last cut."""

    def __init__(self, plan: Sequence[Sequence[int]] = VGG19_PLAN,
                 cuts: Sequence[Tuple[int, int]] = VGG19_CUTS, device=None):
        super().__init__()
        self.plan = tuple(tuple(widths) for widths in plan)
        self.cuts = tuple(cuts)
        channels = 3
        for block_idx, conv_idx in self._layers():
            width = self.plan[block_idx][conv_idx]
            self.add_module(f"conv{block_idx}_{conv_idx}", nn.Conv2d(channels, width, 3, padding=1, device=device))
            channels = width

    def _layers(self):
        """(block, conv) of every convolution up to the last cut."""
        for block_idx, widths in enumerate(self.plan):
            for conv_idx in range(len(widths)):
                yield block_idx, conv_idx
                if (block_idx, conv_idx) == self.cuts[-1]:
                    return

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
        """:param x: (N, H, W, 3) in [0, 1]. :return: the cut activations,
        NCHW, in f32; convolutions in `dtype`."""
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = ((x - mean) / std).to(dtype).permute(0, 3, 1, 2)
        outputs = []
        for block_idx, conv_idx in self._layers():
            if block_idx > 0 and conv_idx == 0:
                x = F.max_pool2d(x, 2)
            layer = getattr(self, f"conv{block_idx}_{conv_idx}")
            x = torch.relu(F.conv2d(x, layer.weight.to(dtype), layer.bias.to(dtype), padding=1))
            if (block_idx, conv_idx) in self.cuts:
                outputs.append(x.to(torch.float32))
        return outputs


def perceptual_loss(
    net: VGGFeatures, observations: torch.Tensor, reconstructed: torch.Tensor, compute_dtype: str = "float32"
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """L1 between VGG features of (N, H, W, 3) images in [0, 1], the
    ground-truth branch without gradient.

    :return: (the sum over cuts, the per-cut means)."""
    dtype = getattr(torch, compute_dtype)
    with torch.no_grad():
        gt = net(observations, dtype)
    rec = net(reconstructed, dtype)
    level_losses = [torch.mean(torch.abs(g - r)) for g, r in zip(gt, rec)]
    return sum(level_losses), level_losses


class LPIPS(nn.Module):
    """Learned perceptual distance: `backbone` (VGG16 to relu5_3) features
    unit-normalized over channels (the norm clipped at 1e-10), squared
    differences weighted by the heads' magnitudes |lin_i| (one weight a
    channel, initialized to 1), the spatial mean of their channel sum,
    summed over the five levels."""

    def __init__(self, device=None):
        super().__init__()
        self.backbone = VGGFeatures(VGG16_PLAN, VGG16_CUTS, device=device)
        for idx, (block, conv) in enumerate(VGG16_CUTS):
            self.register_parameter(f"lin_{idx}", nn.Parameter(torch.ones(VGG16_PLAN[block][conv], device=device)))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """:param a, b: (N, H, W, 3) in [0, 1]. :return: (N,) distances."""
        total = 0.0
        for idx, (fa, fb) in enumerate(zip(self.backbone(a), self.backbone(b))):
            fa = fa / torch.clamp(torch.linalg.norm(fa, dim=1, keepdim=True), min=1e-10)
            fb = fb / torch.clamp(torch.linalg.norm(fb, dim=1, keepdim=True), min=1e-10)
            weight = torch.abs(getattr(self, f"lin_{idx}"))[:, None, None]
            total = total + torch.mean(torch.sum(torch.square(fa - fb) * weight, dim=1), dim=(-2, -1))
        return total


def lpips_distance_fn(net: LPIPS):
    """The evaluators' `lpips_fn`: (N, H, W, 3) NumPy stacks in [0, 1] ->
    (N,) NumPy distances, EMBED_CHUNK frames a pass on the network's
    device, without autograd."""
    from playableenvironments_tpu_torch.eval.distribution_metrics import EMBED_CHUNK

    device = next(net.parameters()).device

    @torch.no_grad()
    def fn(a, b):
        chunks = [(torch.from_numpy(a[i:i + EMBED_CHUNK]), torch.from_numpy(b[i:i + EMBED_CHUNK]))
                  for i in range(0, len(a), EMBED_CHUNK)]
        return torch.cat([net(x.to(device), y.to(device)) for x, y in chunks]).cpu().numpy()

    return fn


def vgg_cosine_similarity(features_a: List[torch.Tensor], features_b: List[torch.Tensor]) -> torch.Tensor:
    """The mean over feature levels of each pair's cosine similarity, every
    level flattened per image. :return: (N,)."""
    sims = []
    for fa, fb in zip(features_a, features_b):
        fa = fa.reshape(fa.shape[0], -1)
        fb = fb.reshape(fb.shape[0], -1)
        num = torch.sum(fa * fb, dim=-1)
        den = torch.linalg.norm(fa, dim=-1) * torch.linalg.norm(fb, dim=-1)
        sims.append(num / torch.clamp(den, min=1e-10))
    return torch.mean(torch.stack(sims), dim=0)


def init_vgg19(cuts: int = 5, device="cuda", seed: int = 7) -> VGGFeatures:
    """VGG19 up to cut `cuts` on seeded random weights, frozen (no
    parameter takes a gradient)."""
    net = VGGFeatures(VGG19_PLAN, VGG19_CUTS[:cuts], device=resolve_device(device))
    initialize_(net, torch.Generator().manual_seed(seed))
    return net.requires_grad_(False).eval()


def convert_torch_vgg_state_dict(state: Mapping[str, torch.Tensor], plan=VGG19_PLAN,
                                 max_block: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A torchvision VGG `features.N.weight` / `.bias` state dict -> the
    names of VGGFeatures (layouts are the same, OIHW): torchvision counts
    conv and ReLU as one index each and every pool as one more."""
    out, torch_idx = {}, 0
    for block_idx, widths in enumerate(plan):
        if max_block is not None and block_idx > max_block:
            break
        for conv_idx in range(len(widths)):
            out[f"conv{block_idx}_{conv_idx}.weight"] = state[f"features.{torch_idx}.weight"]
            out[f"conv{block_idx}_{conv_idx}.bias"] = state[f"features.{torch_idx}.bias"]
            torch_idx += 2
        torch_idx += 1
    return out


def load_torch_vgg_state_dict(net: VGGFeatures, state: Mapping[str, torch.Tensor]) -> VGGFeatures:
    """Load a torchvision VGG19 state dict into `net`, strictly (every conv
    of `net` covered, every shape checked; deeper layers are not read)."""
    converted = convert_torch_vgg_state_dict(state, net.plan, max_block=net.cuts[-1][0])
    net.load_state_dict({name: converted[name] for name in net.state_dict()}, strict=True)
    return net


def load_torch_vgg_weights(path: str, net: VGGFeatures) -> VGGFeatures:
    """Load a torchvision VGG19 checkpoint file (a state dict or a module)
    into `net`; raises FileNotFoundError if the file is absent."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return load_torch_vgg_state_dict(net, state)
