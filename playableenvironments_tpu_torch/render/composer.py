"""SceneComposer: the multi-object volume renderer of the training path.

Port of playableenvironments_tpu/render/composer.py: one
ObjectRadianceField per object model (`object_model_i`) and, with
`separate_fine`, one fine field per `use_fine` model
(`object_model_fine_i`); `forward`, the training-mode render (per-object
stratified samples with optional jitter, field evaluation, the
hierarchical fine pass for `use_fine` objects, per-object integration and
sort-free composition across objects with optional alpha noise), with the
Minecraft scenes' skybox (evaluated once per ray) and overlap fix (static
samples inside a dynamic object's t interval suppressed before the
composition). Eval frames read the same weights through
render/fast.py::render_rays_fast, which raises for `use_fine` as the JAX
fast path does; a `use_fine` model's frames go through
EnvironmentModel.render_frame_from_scene_encoding.
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
from playableenvironments_tpu_torch.utils import remat as remat_lib
from playableenvironments_tpu_torch.utils.device import resolve_device

# The fine fields' generator is seeded apart from the coarse fields' (and
# from seed + 1 .. + 3 of the environment model's other modules), so that
# adding them moves no other seeded weight.
FINE_SEED_OFFSET = 4


class SceneComposer(nn.Module):
    """`object_model_{i}`: one ObjectRadianceField per object model; with
    `scene.separate_fine`, also `object_model_fine_{i}` for each `use_fine`
    model."""

    def __init__(self, scene: SceneConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.scene = scene
        for i, cfg in enumerate(scene.object_models):
            self.add_module(f"object_model_{i}", ObjectRadianceField(cfg, device=device))
        initialize_(self, torch.Generator().manual_seed(seed))
        if scene.separate_fine:
            generator = torch.Generator().manual_seed(seed + FINE_SEED_OFFSET)
            for i, cfg in enumerate(scene.object_models):
                if cfg.use_fine:
                    self.add_module(f"object_model_fine_{i}",
                                    initialize_(ObjectRadianceField(cfg, device=device), generator))
        self.eval()

    def object_model(self, model_idx: int) -> ObjectRadianceField:
        return getattr(self, f"object_model_{model_idx}")

    def fine_object_model(self, model_idx: int) -> ObjectRadianceField:
        """The field of model `model_idx`'s fine pass: its own with separate
        fine fields, else the coarse one."""
        if self.scene.separate_fine:
            return getattr(self, f"object_model_fine_{model_idx}")
        return self.object_model(model_idx)

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
        remat: bool = False,
    ) -> Dict:
        """Render rays through the composed scene.

        :param ray_origins: (..., 3) world origins; ray_directions (..., rays,
            3); focal_normals (..., 3); w2o_matrices (..., objects, 4, 4);
            style / deformation (..., objects, F); object_in_scene (..., objects).
        :param perturb: stratified jitter and alpha noise, drawn from `rng`
            (utils.random.RngStreams or an object with its methods) in the
            JAX composer's order: per object, "sampling" (the strata),
            "divergence" (the probe, with `compute_divergence` on a bent
            object) and, for `use_fine`, "alpha_noise" (the coarse weights),
            "sampling" (sample_pdf) and "divergence" again; then one
            "alpha_noise" draw per object and one for the composition, for
            the coarse pass and then the fine one.
        :param compute_divergence: each positional bender's Hutchinson
            divergence (ObjectRadianceField); needs `rng`.
        :param remat: each field's bender and NeRF and each sort-free
            composite as rematerialized regions (utils/remat.py); the draws
            stay outside them.
        :return: {"coarse": {"object_i": integrate dict, "global": ...}}
            and, with any `use_fine` object, "fine" alike, in which objects
            without a fine pass contribute their coarse samples.
        """
        scene = self.scene
        object_ids = ObjectIds(scene)
        if (perturb or compute_divergence) and rng is None:
            raise ValueError("perturb=True and compute_divergence need the random streams `rng`")
        if w2o_matrices.shape[-3] != object_ids.objects_count:
            raise ValueError(
                f"w2o_matrices carries {w2o_matrices.shape[-3]} objects, scene has {object_ids.objects_count}"
            )

        def evaluate(field, cfg, object_idx, positions, positions_t, o_origins, o_directions):
            probe = None
            if compute_divergence and not canonical_pose and cfg.bender.kind == "positional":
                probe = rng.normal("divergence", positions.shape)
            features, raw_alphas, displacements, divergences = field(
                positions, style[..., object_idx, :], deformation[..., object_idx, :], step, canonical_pose,
                use_running_average, compute_divergence, o_origins, o_directions, probe, remat,
            )
            # Absent objects are fully transparent.
            raw_alphas = torch.where(object_in_scene[..., object_idx, None, None], raw_alphas, cfg.empty_space_alpha)
            if scene.apply_activation:
                features = torch.sigmoid(features)
            return {"features": features, "raw_alphas": raw_alphas, "t": positions_t,
                    "displacements": displacements, "divergences": divergences}

        per_object_coarse, per_object_fine = [], []
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
            coarse = evaluate(self.object_model(model_idx), cfg, object_idx, positions, positions_t, o_origins,
                              o_directions)
            per_object_coarse.append(coarse)
            if not cfg.use_fine:
                per_object_fine.append(None)
                continue
            # Hierarchical resampling from the coarse weights, which only
            # place the new samples (their t is detached).
            with torch.no_grad():
                noise = rng.normal("alpha_noise", coarse["raw_alphas"].shape) if perturb else None
                alphas = compositing.alphas_from_raw(
                    coarse["raw_alphas"], compositing.position_distances(coarse["t"], o_directions), noise)
                weights = compositing.compositing_weights(alphas)
            uniform = rng.uniform("sampling", weights.shape[:-1] + (cfg.positions_count_fine,)) if perturb else None
            fine_positions, fine_t = rays_lib.weighted_ray_positions(
                o_origins, o_directions, cfg.positions_count_fine, coarse["t"], weights, uniform
            )
            per_object_fine.append(evaluate(self.fine_object_model(model_idx), cfg, object_idx, fine_positions,
                                            fine_t, o_origins, o_directions))

        results = {"coarse": self._compose_and_integrate(per_object_coarse, ray_origins, ray_directions, perturb,
                                                         rng, remat)}
        if any(f is not None for f in per_object_fine):
            fine = [f if f is not None else c for f, c in zip(per_object_fine, per_object_coarse)]
            results["fine"] = self._compose_and_integrate(fine, ray_origins, ray_directions, perturb, rng, remat)
        return results

    def _compose_and_integrate(self, per_object: List[Dict], ray_origins, ray_directions, perturb: bool,
                               rng, remat: bool = False) -> Dict:
        results = {}
        for object_idx, obj in enumerate(per_object):
            noise = rng.normal("alpha_noise", obj["raw_alphas"].shape) if perturb else None
            results[f"object_{object_idx}"] = compositing.integrate(
                obj["features"], obj["raw_alphas"], ray_directions, obj["t"],
                obj["displacements"], obj["divergences"], noise,
            )
        all_alphas = [o["raw_alphas"] for o in per_object]
        all_t = [o["t"] for o in per_object]
        all_displacements = [o["displacements"] for o in per_object]
        all_divergences = [o["divergences"] for o in per_object]
        if self.scene.fix_object_overlaps:
            # Static samples inside any dynamic object's t interval become
            # empty space at t = 0; the sort-free composition needs no order.
            object_ids = ObjectIds(self.scene)
            for s in range(object_ids.static_objects_count):
                mask = torch.zeros_like(all_t[s], dtype=torch.bool)
                for d in range(object_ids.static_objects_count, object_ids.objects_count):
                    mask = mask | compositing.overlap_fix_mask(all_t[s], all_t[d])
                all_alphas[s], all_t[s], _, all_displacements[s], all_divergences[s] = compositing.apply_overlap_fix(
                    all_alphas[s], all_t[s], torch.zeros_like(all_displacements[s]), all_displacements[s],
                    all_divergences[s], ray_origins[..., None, :], mask,
                )
        shape = all_alphas[0].shape[:-1] + (sum(a.shape[-1] for a in all_alphas),)
        noise = rng.normal("alpha_noise", shape) if perturb else None
        count = len(per_object)

        def composite(ray_directions, noise, *flat):
            lists = [list(flat[i * count : (i + 1) * count]) for i in range(5)]
            return compositing.compose_integrate_sortfree(
                lists[0], lists[1], lists[2], ray_directions, all_ray_displacements=lists[3],
                all_ray_divergences=lists[4], noise=noise,
            )

        flat = [o["features"] for o in per_object] + all_alphas + all_t + all_displacements + all_divergences
        results["global"] = (remat_lib.checkpointed(composite, ray_directions, noise, *flat) if remat
                             else composite(ray_directions, noise, *flat))
        return results
