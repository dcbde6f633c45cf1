"""Radiance-field modules: the style-modulated NeRF MLP, the ray bender and
the per-object field.

Port of playableenvironments_tpu/models/nerf.py: AdaInNerfMLP,
SkyboxNerfMLP, PositionalRayBender and ObjectRadianceField (with the
bender's Hutchinson divergence and, under remat, its regions), with the
flax parameter names (backbone_i, alpha_head, feat_0/1, feat_out, adain_0/1,
ray_bender/backbone_i, output_head). Their `forward` is the training path
(and eval with `use_running_average`); the eval frame path reads the same
weights through render/fast.py, the AdaIN NeRF through the B1 kernel
(ops/fused_nerf.py), the skybox as plain products, once per ray.

Matmuls run in `compute_dtype` as flax's Dense with `dtype` does (operands
and outputs in that dtype), the fused backbone through the B2/B3 kernels;
positional encodings, AdaIN statistics and outputs stay f32.
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
from playableenvironments_tpu_torch.core.bbox import aabb_contains, aabb_size
from playableenvironments_tpu_torch.models.encoding import annealing_weights, positional_encoding
from playableenvironments_tpu_torch.models.layers import AffineTransformAdaIn
from playableenvironments_tpu_torch.ops import fused_nerf
from playableenvironments_tpu_torch.utils import remat as remat_lib


def _encoding_size(input_dims: int, pe_cfg) -> int:
    return 2 * pe_cfg.octaves * input_dims + (input_dims if pe_cfg.append_original else 0)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dtype): input, kernel and bias cast to `dtype`, the
    product and the bias sum in it."""
    y = x.to(dtype) @ layer.weight.t().to(dtype)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


def _box(cfg_box, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(cfg_box, dtype=like.dtype, device=like.device)


class AdaInNerfMLP(nn.Module):
    """W-wide, L-layer MLP with a mid-backbone skip and an AdaIN-modulated
    feature head, over the positional encoding of bbox-normalized points."""

    def __init__(self, cfg: NerfMLPConfig, style_features: int, device=None):
        super().__init__()
        self.cfg = cfg
        _add_backbone(self, cfg, _encoding_size(3, cfg.position_encoder), device)
        self.alpha_head = nn.Linear(cfg.layers_width, 1, device=device)
        _add_feature_head(self, cfg, style_features, device)
        self._kernel_cache: Optional[Tuple[tuple, fused_nerf.NerfKernelWeights]] = None

    def kernel_weights(self) -> fused_nerf.NerfKernelWeights:
        """The weights packed for the kernel, rebuilt only after a parameter
        changes (its storage or its in-place version counter); built anew
        from the parameters while torch.export traces (fused_nerf.tracing)."""
        if fused_nerf.is_tracing():
            return fused_nerf.kernel_weights(self.cfg, fused_nerf.pack_nerf_params(self.cfg, self))
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            packed = fused_nerf.pack_nerf_params(self.cfg, self)
            self._kernel_cache = (key, fused_nerf.kernel_weights(self.cfg, packed))
        return self._kernel_cache[1]

    def backbone_params(self) -> dict:
        """The backbone's weights as the fused backbone takes them (views of
        the parameters, so gradients reach them)."""
        packed = {}
        for i in range(self.cfg.backbone_layers_count):
            layer = getattr(self, f"backbone_{i}")
            packed[f"w{i}"] = layer.weight.t()
            packed[f"b{i}"] = layer.bias
        packed["w_alpha"] = self.alpha_head.weight.t()
        packed["b_alpha"] = self.alpha_head.bias
        return packed

    def forward(
        self,
        positions: torch.Tensor,
        box,
        style: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        use_running_average: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:param positions: (..., 3) object-frame points; :param box: the
        object's (3, 2) bounding box (positions are divided by its size).
        :param style: broadcastable (..., style_features).
        :param mask: (...) validity for the AdaIN statistics.
        :return: ((..., output_features) f32 features, (...) f32 raw alpha).
        """
        h, alpha = self.backbone_and_alpha(positions, box)
        return _feature_head(self, h, style, mask, use_running_average, getattr(torch, self.cfg.compute_dtype)), alpha

    def backbone_and_alpha(self, positions: torch.Tensor, box) -> Tuple[torch.Tensor, torch.Tensor]:
        """The backbone's output and the raw alpha, without the feature
        head: ((..., W) h in the compute dtype, (...) f32 raw alpha)."""
        cfg = self.cfg
        pe_cfg = cfg.position_encoder
        encoded = positional_encoding(positions / aabb_size(_box(box, positions)), pe_cfg.octaves,
                                      pe_cfg.append_original)
        if cfg.use_fused_backbone:
            flat = encoded.to(torch.float32).reshape(-1, encoded.shape[-1])
            h_flat, alpha_flat = fused_nerf.fused_backbone(cfg, self.backbone_params(), flat)
            return (h_flat.reshape(encoded.shape[:-1] + (cfg.layers_width,)),
                    alpha_flat.reshape(encoded.shape[:-1]))
        dtype = getattr(torch, cfg.compute_dtype)
        h = _backbone(self, cfg, encoded.to(dtype), dtype)
        return h, dense(h, self.alpha_head, dtype)[..., 0].to(torch.float32)


class SkyboxNerfMLP(nn.Module):
    """Fully opaque skybox: features from the positional encoding of the
    box-normalized ray origin and the unit ray direction (6 inputs), alpha
    forced to 10. It ignores the sample position, so callers evaluate it
    once per ray and broadcast over the samples."""

    occupied_space_alpha = 10.0

    def __init__(self, cfg: NerfMLPConfig, style_features: int, device=None):
        super().__init__()
        self.cfg = cfg
        _add_backbone(self, cfg, _encoding_size(6, cfg.position_encoder), device)
        _add_feature_head(self, cfg, style_features, device)

    def forward(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        box,
        style: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        use_running_average: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:param origins, directions: (..., 3) object-frame ray origins and
        directions; :param box: the object's (3, 2) bounding box.
        :param style: broadcastable (..., style_features).
        :param mask: (...) validity for the AdaIN statistics.
        :return: ((..., output_features) f32 features, (...) alphas of 10).
        """
        cfg = self.cfg
        pe_cfg = cfg.position_encoder
        unit_dirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
        x = torch.cat([origins / aabb_size(_box(box, origins)), unit_dirs], dim=-1)
        dtype = getattr(torch, cfg.compute_dtype)
        encoded = positional_encoding(x, pe_cfg.octaves, pe_cfg.append_original).to(dtype)
        features = _feature_head(self, _backbone(self, cfg, encoded, dtype), style, mask, use_running_average,
                                 dtype)
        return features, torch.full(features.shape[:-1], self.occupied_space_alpha, dtype=features.dtype,
                                    device=features.device)


def _add_backbone(module: nn.Module, cfg: NerfMLPConfig, pe: int, device) -> None:
    """`backbone_i`: L layers of width W over a `pe`-wide encoding, which is
    concatenated again at `skip_layer_idx`; at skip_layer_idx 0 layer 0
    reads [encoding, encoding], as flax's Dense infers it, except on the
    fused backbone's path, which declares the JAX kernel's sizes
    (fused_nerf._backbone_sizes: no skip at 0)."""
    w = cfg.layers_width
    doubled = cfg.skip_layer_idx == 0 and not cfg.use_fused_backbone
    for i in range(cfg.backbone_layers_count):
        fan_in = (2 * pe if doubled else pe) if i == 0 else (w + pe if i == cfg.skip_layer_idx else w)
        module.add_module(f"backbone_{i}", nn.Linear(fan_in, w, device=device))


def _add_feature_head(module: nn.Module, cfg: NerfMLPConfig, style_features: int, device) -> None:
    """feat_0 (W) -> adain_0 -> feat_1 (W / 2) -> adain_1 -> feat_out."""
    w = cfg.layers_width
    module.feat_0 = nn.Linear(w, w, bias=False, device=device)
    module.adain_0 = AffineTransformAdaIn(w, style_features, device=device)
    module.feat_1 = nn.Linear(w, w // 2, bias=False, device=device)
    module.adain_1 = AffineTransformAdaIn(w // 2, style_features, device=device)
    module.feat_out = nn.Linear(w // 2, cfg.output_features, device=device)


def _backbone(module: nn.Module, cfg: NerfMLPConfig, encoded: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    h = encoded
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx:
            h = torch.cat([h, encoded], dim=-1)
        h = torch.relu(dense(h, getattr(module, f"backbone_{i}"), dtype))
    return h


def _feature_head(module: nn.Module, h, style, mask, use_running_average: bool, dtype) -> torch.Tensor:
    """Dense -> AdaIN -> ReLU -> Dense -> AdaIN -> ReLU -> Dense, AdaIN in f32."""
    f = dense(h, module.feat_0, dtype).to(torch.float32)
    f = torch.relu(module.adain_0(f, style, mask, use_running_average))
    f = dense(f, module.feat_1, dtype).to(torch.float32)
    f = torch.relu(module.adain_1(f, style, mask, use_running_average))
    return dense(f, module.feat_out, dtype).to(torch.float32)


class PositionalRayBender(nn.Module):
    """Deformation field: annealed-PE(pos) ++ deformation code -> MLP ->
    displacement, clamped so that bent points stay inside the box (the eval
    frame path computes it in f32 in render.fast._bender_displacements)."""

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

    def forward(self, positions: torch.Tensor, box, deformation: torch.Tensor, step) -> torch.Tensor:
        """:param positions: (..., 3) object-frame points.
        :param deformation: broadcastable (..., deformation_features).
        :param step: training step driving the PE annealing.
        :return: (..., 3) displacements.
        """
        cfg = self.cfg
        box = _box(box, positions)
        size = aabb_size(box)
        pe_cfg = cfg.position_encoder
        weights = (annealing_weights(pe_cfg.octaves, step, pe_cfg.num_steps, device=positions.device)
                   if pe_cfg.num_steps else None)
        encoded = positional_encoding(positions / size, pe_cfg.octaves, pe_cfg.append_original, weights)
        deformation = deformation.expand(positions.shape[:-1] + deformation.shape[-1:])
        inputs = torch.cat([encoded, deformation], dim=-1)
        dtype = getattr(torch, cfg.compute_dtype)
        h = inputs.to(dtype)
        for i in range(cfg.layers_count):
            if i == cfg.skip_layer_idx:
                h = torch.cat([h, inputs.to(dtype)], dim=-1)
            h = torch.relu(dense(h, getattr(self, f"backbone_{i}"), dtype))
        displacements = dense(h.to(torch.float32), self.output_head, torch.float32) * size
        return torch.minimum(torch.maximum(displacements, box[:, 0] - positions), box[:, 1] - positions)


class ObjectRadianceField(nn.Module):
    """One object model: `nerf` and, for bent objects, `ray_bender`. Every
    sample is evaluated; samples outside the box yield features 0, alpha
    `empty_space_alpha` and displacement 0."""

    def __init__(self, cfg: ObjectModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        mlp = SkyboxNerfMLP if cfg.nerf.kind == "skybox" else AdaInNerfMLP
        self.nerf = mlp(cfg.nerf, cfg.style_features, device=device)
        if cfg.bender.kind == "positional":
            self.ray_bender = PositionalRayBender(
                cfg.bender, cfg.deformation_features, device=device
            )

    def forward(
        self,
        ray_positions: torch.Tensor,
        style: torch.Tensor,
        deformation: torch.Tensor,
        step=0,
        canonical_pose: bool = False,
        use_running_average: bool = False,
        compute_divergence: bool = False,
        ray_origins: Optional[torch.Tensor] = None,
        ray_directions: Optional[torch.Tensor] = None,
        divergence_probe: Optional[torch.Tensor] = None,
        remat: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """:param ray_positions: (..., rays, positions, 3) object-frame points.
        :param style: (..., style_features); deformation (..., deformation_features).
        :param ray_origins, ray_directions: (..., 3) and (..., rays, 3)
            object-frame rays, read by the skybox only.
        :param compute_divergence: estimate the bent displacement field's
            divergence by Hutchinson's e^T J e with the standard-normal probe
            `divergence_probe` (the positions' shape; the caller draws it
            from the "divergence" stream), differentiable in the bender's
            parameters through the second-order graph. Zero under
            `canonical_pose` and outside the box.
        :param remat: the bender and the NeRF as rematerialized regions
            (utils/remat.py): the NeRF under the selective policy, the
            bender whole (its divergence takes a derivative inside).
        :return: ((..., rays, positions, F) features, (..., rays, positions)
            raw alphas, (..., rays, positions, 3) displacements,
            (..., rays, positions) divergences).
        """
        cfg = self.cfg
        mask = aabb_contains(_box(cfg.bounding_box, ray_positions), ray_positions)
        deformation_b = deformation[..., None, None, :]
        divergences = torch.zeros(ray_positions.shape[:-1], dtype=ray_positions.dtype,
                                  device=ray_positions.device)
        if cfg.bender.kind == "positional":
            with_divergence = compute_divergence and not canonical_pose
            if with_divergence and divergence_probe is None:
                raise ValueError("compute_divergence needs the probe `divergence_probe`")

            def bend(positions, deformation_b, probe):
                if with_divergence:
                    return self._bend_with_divergence(positions, deformation_b, step, probe)
                return self.ray_bender(positions, cfg.bounding_box, deformation_b, step), divergences

            displacements, divergences = (remat_lib.checkpointed(bend, ray_positions, deformation_b, divergence_probe,
                                                                 selective=False)
                                          if remat else bend(ray_positions, deformation_b, divergence_probe))
            if canonical_pose:
                displacements = displacements * 0.0
            displacements = torch.where(mask[..., None], displacements, 0.0)
            divergences = torch.where(mask, divergences, 0.0)
        else:
            displacements = torch.zeros_like(ray_positions)

        def radiance(ray_positions, displacements, style, ray_origins, ray_directions):
            if cfg.nerf.kind == "skybox":
                # Constant along each ray: one evaluation per ray, repeated
                # over the samples (autograd sums the repeats' gradients).
                origins = ray_origins[..., None, :].expand(ray_directions.shape)
                features, alpha = self.nerf(origins, ray_directions, cfg.bounding_box, style[..., None, :],
                                            mask.any(dim=-1), use_running_average)
                samples = ray_positions.shape[-2]
                features = features[..., None, :].expand(features.shape[:-1] + (samples, features.shape[-1]))
                alpha = alpha[..., None].expand(alpha.shape + (samples,))
            else:
                features, alpha = self.nerf(ray_positions + displacements, cfg.bounding_box,
                                            style[..., None, None, :], mask, use_running_average)
            return torch.where(mask[..., None], features, 0.0), torch.where(mask, alpha, cfg.empty_space_alpha)

        args = (ray_positions, displacements, style, ray_origins, ray_directions)
        features, alpha = remat_lib.checkpointed(radiance, *args) if remat else radiance(*args)
        return features, alpha, displacements, divergences

    def alphas_and_displacements(self, ray_positions: torch.Tensor, deformation: torch.Tensor, step=0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The raw alphas and displacements of `forward` (no divergence, no
        canonical pose) without the feature head: all that the consistency
        passes read. The AdaIN norms do not run, so no running statistic
        moves. Not for the skybox, whose alpha is a constant.

        :return: ((..., rays, positions) raw alphas, (..., rays, positions,
            3) displacements).
        """
        cfg = self.cfg
        if cfg.nerf.kind == "skybox":
            raise ValueError("alphas_and_displacements: the skybox has no field of alphas")
        mask = aabb_contains(_box(cfg.bounding_box, ray_positions), ray_positions)
        if cfg.bender.kind == "positional":
            displacements = self.ray_bender(ray_positions, cfg.bounding_box, deformation[..., None, None, :], step)
            displacements = torch.where(mask[..., None], displacements, 0.0)
        else:
            displacements = torch.zeros_like(ray_positions)
        _, alpha = self.nerf.backbone_and_alpha(ray_positions + displacements, cfg.bounding_box)
        return torch.where(mask, alpha, cfg.empty_space_alpha), displacements

    def _bend_with_divergence(self, positions, deformation, step, probe):
        """The bender's displacements and e^T (d displacements / d positions) e
        for the probe e, as JAX's `nn.vjp` of the bender gives them. With
        grad mode on, the vector-Jacobian product keeps its graph, so a loss
        on the divergence reaches the bender's parameters (and the
        positions) through second derivatives."""
        outer_grad = torch.is_grad_enabled()
        with torch.enable_grad():
            if not positions.requires_grad:
                positions = positions.detach().requires_grad_(True)
            displacements = self.ray_bender(positions, self.cfg.bounding_box, deformation, step)
            (e_jacobian,) = torch.autograd.grad(displacements, positions, probe, create_graph=outer_grad)
        divergences = torch.sum(e_jacobian * probe, dim=-1)
        if not outer_grad:
            displacements, divergences = displacements.detach(), divergences.detach()
        return displacements, divergences
