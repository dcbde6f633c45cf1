"""Radiance-field parameter modules for the eval frame path.

Port of playableenvironments_tpu/models/nerf.py: AdaInNerfMLP,
PositionalRayBender and ObjectRadianceField, with the flax parameter names
(backbone_i, alpha_head, feat_0/1, feat_out, adain_0/1, ray_bender/backbone_i,
output_head) and running-average AdaIN statistics. They hold weights; the
forward computation is render/fast.py (the bender) and ops/fused_nerf.py
(the NeRF MLP kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from playableenvironments_tpu_torch.config import (
    NerfMLPConfig,
    ObjectModelConfig,
    RayBenderConfig,
)
from playableenvironments_tpu_torch.models.layers import AffineTransformAdaIn
from playableenvironments_tpu_torch.ops import fused_nerf


def _encoding_size(input_dims: int, pe_cfg) -> int:
    return 2 * pe_cfg.octaves * input_dims + (input_dims if pe_cfg.append_original else 0)


class AdaInNerfMLP(nn.Module):
    """W-wide, L-layer MLP with a mid-backbone skip and an AdaIN-modulated
    feature head, over the positional encoding of bbox-normalized points."""

    def __init__(self, cfg: NerfMLPConfig, style_features: int, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.layers_width
        pe = _encoding_size(3, cfg.position_encoder)
        for i in range(cfg.backbone_layers_count):
            fan_in = pe if i == 0 else (w + pe if i == cfg.skip_layer_idx else w)
            self.add_module(f"backbone_{i}", nn.Linear(fan_in, w, device=device))
        self.alpha_head = nn.Linear(w, 1, device=device)
        self.feat_0 = nn.Linear(w, w, bias=False, device=device)
        self.adain_0 = AffineTransformAdaIn(w, style_features, device=device)
        self.feat_1 = nn.Linear(w, w // 2, bias=False, device=device)
        self.adain_1 = AffineTransformAdaIn(w // 2, style_features, device=device)
        self.feat_out = nn.Linear(w // 2, cfg.output_features, device=device)
        self._kernel_cache: Optional[Tuple[tuple, fused_nerf.NerfKernelWeights]] = None

    def kernel_weights(self) -> fused_nerf.NerfKernelWeights:
        """The weights packed for the kernel, rebuilt only after a parameter
        changes (its storage or its in-place version counter)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            packed = fused_nerf.pack_nerf_params(self.cfg, self)
            self._kernel_cache = (key, fused_nerf.kernel_weights(self.cfg, packed))
        return self._kernel_cache[1]


class PositionalRayBender(nn.Module):
    """Deformation field weights: annealed-PE(pos) ++ deformation code ->
    MLP -> displacement (computed by render.fast._bender_displacements)."""

    def __init__(self, cfg: RayBenderConfig, deformation_features: int, device=None):
        super().__init__()
        self.cfg = cfg
        inputs = _encoding_size(3, cfg.position_encoder) + deformation_features
        w = cfg.layers_width
        for i in range(cfg.layers_count):
            fan_in = inputs if i == 0 else (w + inputs if i == cfg.skip_layer_idx else w)
            self.add_module(f"backbone_{i}", nn.Linear(fan_in, w, device=device))
        self.output_head = nn.Linear(w, 3, bias=False, device=device)

    def reset_special_(self, generator: torch.Generator) -> None:
        # Near-zero displacements at init (flax uniform(scale=1e-5)).
        with torch.no_grad():
            u = torch.rand(self.output_head.weight.shape, generator=generator)
            self.output_head.weight.copy_(u * 1e-5)


class ObjectRadianceField(nn.Module):
    """One object model's weights: `nerf` and, for bent objects, `ray_bender`."""

    def __init__(self, cfg: ObjectModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.nerf.kind != "adain":
            raise NotImplementedError(
                f"nerf kind {cfg.nerf.kind!r} (the Minecraft skybox) is not "
                "ported yet; it comes with the Minecraft slice"
            )
        self.nerf = AdaInNerfMLP(cfg.nerf, cfg.style_features, device=device)
        if cfg.bender.kind == "positional":
            self.ray_bender = PositionalRayBender(
                cfg.bender, cfg.deformation_features, device=device
            )
