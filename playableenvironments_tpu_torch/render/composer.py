"""SceneComposer: the multi-object volume renderer of the training path.

Port of playableenvironments_tpu/render/composer.py: one
ObjectRadianceField per object model (`object_model_i`), and `forward`, the
training-mode render (per-object stratified samples with optional jitter,
field evaluation, per-object integration and sort-free composition across
objects with optional alpha noise). Eval frames read the same weights
through render/fast.py::render_rays_fast. The fine hierarchy (`use_fine`)
and `fix_object_overlaps` raise, as in the fast path.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from playableenvironments_tpu_torch.config import ObjectIds, SceneConfig
from playableenvironments_tpu_torch.core import bbox as bbox_lib
from playableenvironments_tpu_torch.core import compositing
from playableenvironments_tpu_torch.core import rays as rays_lib
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.models.nerf import ObjectRadianceField
from playableenvironments_tpu_torch.utils.device import resolve_device


class SceneComposer(nn.Module):
    """`object_model_{i}`: one ObjectRadianceField per object model."""

    def __init__(self, scene: SceneConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.scene = scene
        for i, cfg in enumerate(scene.object_models):
            self.add_module(f"object_model_{i}", ObjectRadianceField(cfg, device=device))
        initialize_(self, torch.Generator().manual_seed(seed))
        self.eval()

    def object_model(self, model_idx: int) -> ObjectRadianceField:
        return getattr(self, f"object_model_{model_idx}")

    def forward(
        self,
        ray_origins: torch.Tensor,
        ray_directions: torch.Tensor,
        focal_normals: torch.Tensor,
        w2o_matrices: torch.Tensor,
        style: torch.Tensor,
        deformation: torch.Tensor,
        object_in_scene: torch.Tensor,
        perturb: bool = False,
        rng=None,
        step=0,
        canonical_pose: bool = False,
        use_running_average: bool = False,
        compute_divergence: bool = False,
    ) -> Dict:
        """Render rays through the composed scene.

        :param ray_origins: (..., 3) world origins; ray_directions (..., rays,
            3); focal_normals (..., 3); w2o_matrices (..., objects, 4, 4);
            style / deformation (..., objects, F); object_in_scene (..., objects).
        :param perturb: stratified jitter ("sampling" stream, one uniform
            draw per object) and alpha noise ("alpha_noise", one normal draw
            per object and one for the composition), drawn from `rng`
            (utils.random.RngStreams or an object with its methods).
        :return: {"coarse": {"object_i": integrate dict, "global": ...}}.
        """
        scene = self.scene
        object_ids = ObjectIds(scene)
        if any(cfg.use_fine for cfg in scene.object_models):
            raise NotImplementedError("use_fine (the hierarchical fine pass, sample_pdf) is not ported yet")
        if scene.fix_object_overlaps:
            raise NotImplementedError("fix_object_overlaps (the Minecraft scenes) is not ported yet")
        if perturb and rng is None:
            raise ValueError("perturb=True needs the random streams `rng`")
        if w2o_matrices.shape[-3] != object_ids.objects_count:
            raise ValueError(
                f"w2o_matrices carries {w2o_matrices.shape[-3]} objects, scene has {object_ids.objects_count}"
            )

        per_object = []
        for object_idx in range(object_ids.objects_count):
            model_idx = object_ids.model_idx_by_object_idx(object_idx)
            cfg = scene.object_models[model_idx]
            o_origins, o_directions, _ = rays_lib.transform_rays(
                ray_origins, ray_directions, focal_normals, w2o_matrices[..., object_idx, :, :]
            )
            box = torch.as_tensor(cfg.bounding_box, dtype=ray_origins.dtype, device=ray_origins.device)
            in_scene = object_in_scene[..., object_idx]
            z_near, z_far = bbox_lib.ray_aabb_bounds(o_origins, o_directions, box, in_scene)
            z_near = torch.clamp(z_near, cfg.z_near_min, cfg.z_far_max)
            z_far = torch.clamp(z_far, cfg.z_near_min, cfg.z_far_max)
            samples = cfg.positions_count_coarse
            uniform = rng.uniform("sampling", z_near.shape + (samples,)) if perturb else None
            positions, positions_t = rays_lib.stratified_ray_positions(
                o_origins, o_directions, z_near, z_far, samples, uniform
            )
            features, raw_alphas, displacements, divergences = self.object_model(model_idx)(
                positions, style[..., object_idx, :], deformation[..., object_idx, :], step,
                canonical_pose, use_running_average, compute_divergence,
            )
            # Absent objects are fully transparent.
            raw_alphas = torch.where(in_scene[..., None, None], raw_alphas, cfg.empty_space_alpha)
            if scene.apply_activation:
                features = torch.sigmoid(features)
            per_object.append({
                "features": features, "raw_alphas": raw_alphas, "t": positions_t,
                "displacements": displacements, "divergences": divergences,
            })
        return {"coarse": self._compose_and_integrate(per_object, ray_directions, perturb, rng)}

    @staticmethod
    def _compose_and_integrate(per_object: List[Dict], ray_directions, perturb: bool, rng) -> Dict:
        results = {}
        for object_idx, obj in enumerate(per_object):
            noise = rng.normal("alpha_noise", obj["raw_alphas"].shape) if perturb else None
            results[f"object_{object_idx}"] = compositing.integrate(
                obj["features"], obj["raw_alphas"], ray_directions, obj["t"],
                obj["displacements"], obj["divergences"], noise,
            )
        all_alphas = [o["raw_alphas"] for o in per_object]
        shape = all_alphas[0].shape[:-1] + (sum(a.shape[-1] for a in all_alphas),)
        noise = rng.normal("alpha_noise", shape) if perturb else None
        results["global"] = compositing.compose_integrate_sortfree(
            [o["features"] for o in per_object], all_alphas, [o["t"] for o in per_object],
            ray_directions,
            all_ray_displacements=[o["displacements"] for o in per_object],
            all_ray_divergences=[o["divergences"] for o in per_object],
            noise=noise,
        )
        return results
