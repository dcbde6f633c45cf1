"""EnvironmentModel: observations -> scene encoding -> rendered rays.

Port of the training path of
playableenvironments_tpu/render/environment_model.py: object poses from the
parameter strategies, projected object boxes, object style/deformation codes
from the object encoders (with the temporal style shuffle), the scene
encoding, ray sampling (weighted, uniform, the whole-image strided grid,
or one strided multi-resolution patch per image), the composed render, the
ray-to-object distances and, on the decoder path (`decode_patches`), the
autoencoder's decode of the rendered feature patches. Random draws come
from `rng` (utils.random.RngStreams). Per-frame camera offsets raise
NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from playableenvironments_tpu_torch.config import ObjectIds, SceneConfig
from playableenvironments_tpu_torch.core import bbox as bbox_lib
from playableenvironments_tpu_torch.core import rays as rays_lib
from playableenvironments_tpu_torch.core.transforms3d import euler_translation_to_matrix, invert_rigid
from playableenvironments_tpu_torch.models.autoencoder import (
    MultiresAutoencoder,
    autoencoder_strides,
    features_count_by_layer,
)
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.models.object_encoders import object_encoder
from playableenvironments_tpu_torch.models.parameter_encoders import (
    ObjectParametersEncoderV4,
    classic_object_poses,
    static_object_poses,
)
from playableenvironments_tpu_torch.render import sampling
from playableenvironments_tpu_torch.render.composer import SceneComposer
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.utils.device import resolve_device


class EnvironmentModel(nn.Module):
    """The synthesis model's training surface: `composer`,
    `object_encoder_i`, for learned poses `parameters_encoder_i` and, where
    the scene has one, the full `autoencoder` (encoder and decoder, as the
    JAX model materializes both; the flax tree's names). The autoencoder
    takes a generator of its own seeded from `seed` + 1, decoder first, so
    that its decoder is the one the play session has always been seeded
    with and no other module's weights move."""

    def __init__(self, scene: SceneConfig, focal_length_multiplier: float = 1.0,
                 enable_camera_offsets: bool = False, device="cuda", seed: int = 0):
        super().__init__()
        if enable_camera_offsets:
            raise NotImplementedError("per-frame camera offsets (enable_camera_offsets) are not ported yet")
        device = resolve_device(device)
        self.scene = scene
        self.focal_length_multiplier = focal_length_multiplier
        self.object_ids = ObjectIds(scene)
        self.composer = SceneComposer(scene, device=device, seed=seed)
        generator = torch.Generator().manual_seed(seed + 1)
        for i, cfg in enumerate(scene.object_encoders):
            self.add_module(f"object_encoder_{i}", initialize_(object_encoder(cfg, device=device), generator))
        generator = torch.Generator().manual_seed(seed + 3)
        for i, cfg in enumerate(scene.parameter_encoders):
            if cfg.kind == "learned_v4":
                self.add_module(f"parameters_encoder_{i}",
                                initialize_(ObjectParametersEncoderV4(cfg, device=device), generator))
        if scene.autoencoder is not None:
            self.autoencoder = MultiresAutoencoder(scene.autoencoder, device=device, seed=seed + 1)

    # ---- scene encoding --------------------------------------------------

    def _compute_object_poses(self, observations, w2c_first, camera_rotations_first, focals_first, bounding_boxes,
                              boxes_validity, train: bool):
        """Per-object o2w poses from each model's strategy (first camera;
        camera parameters detached). The learned strategy runs its CNN on the
        first camera's frames, flattened over (B, T).

        :param observations: (B, T, C, H, W, 3); w2c_first (B, T, 4, 4);
            camera_rotations_first (B, T, 3); focals_first (B, T);
            bounding_boxes (B, T, dynamic_objects, 4); boxes_validity (B, T, dynamic_objects).
        :return: ((B, T, O, 3) rotations, (B, T, O, 3) translations).
        """
        w2c_first, focals_first = w2c_first.detach(), focals_first.detach()
        image_size = tuple(observations.shape[-3:-1])
        batch_shape = tuple(w2c_first.shape[:2])
        rotations, translations, dynamic_begin = [], [], 0
        for model_idx, cfg in enumerate(self.scene.parameter_encoders):
            if cfg.kind == "static":
                rot, trans = static_object_poses(cfg, batch_shape, device=w2c_first.device)
            else:
                count = cfg.objects_count
                boxes = bounding_boxes[..., dynamic_begin : dynamic_begin + count, :]
                validity = boxes_validity[..., dynamic_begin : dynamic_begin + count]
                dynamic_begin += count
                if cfg.kind == "classic":
                    rot, trans = classic_object_poses(cfg, w2c_first, focals_first, boxes, validity, image_size)
                else:  # learned_v4
                    rot, trans = getattr(self, f"parameters_encoder_{model_idx}")(
                        observations[:, :, 0].reshape((-1,) + observations.shape[-3:]),
                        w2c_first.reshape(-1, 4, 4), camera_rotations_first.reshape(-1, 3),
                        focals_first.reshape(-1), boxes.reshape((-1,) + boxes.shape[-2:]),
                        validity.reshape(-1, count), train=train,
                    )
                    rot = rot.reshape(batch_shape + rot.shape[-2:])
                    trans = trans.reshape(batch_shape + trans.shape[-2:])
            rotations.append(rot)
            translations.append(trans)
        return torch.cat(rotations, dim=-2), torch.cat(translations, dim=-2)

    def compute_object_bounding_boxes(self, o2w_matrices, w2c_matrices, focals, height: int, width: int):
        """Project each object's box edge points into every camera and fit a
        screen box.

        :param o2w_matrices: (B, T, O, 4, 4); w2c_matrices (B, T, C, 4, 4); focals (B, T, C).
        :return: ((B, T, C, O, 4) normalized (l, t, r, b) boxes in [0, 1],
            (B, T, C, O, P, 2) projected edge points in [0, 1]).
        """
        all_boxes, all_points = [], []
        flip = torch.tensor([1.0, -1.0], dtype=focals.dtype, device=focals.device)
        for object_idx in range(self.object_ids.objects_count):
            cfg = self.scene.object_models[self.object_ids.model_idx_by_object_idx(object_idx)]
            box = torch.as_tensor(cfg.bounding_box, dtype=focals.dtype, device=focals.device)
            points = bbox_lib.aabb_edge_points(box)
            world_points = rays_lib.transform_points(points, o2w_matrices[..., object_idx, None, :, :])
            camera_points = rays_lib.transform_points(world_points[..., None, :, :], w2c_matrices[..., None, :, :])
            z = camera_points[..., 2:3]
            z_safe = torch.where(torch.abs(z) < 1e-6, -1e-6, z)
            projected = -camera_points[..., :2] / z_safe * focals[..., None, None] * flip
            behind = camera_points[..., 2] > 0
            for_min = torch.where(behind[..., None], 1e20, projected)
            for_max = torch.where(behind[..., None], -1e20, projected)
            all_boxes.append(torch.stack([
                for_min[..., 0].amin(dim=-1), for_min[..., 1].amin(dim=-1),
                for_max[..., 0].amax(dim=-1), for_max[..., 1].amax(dim=-1),
            ], dim=-1))
            all_points.append(projected)
        boxes = torch.stack(all_boxes, dim=-2)
        points = torch.stack(all_points, dim=-3)
        size = torch.tensor([width, height], dtype=boxes.dtype, device=boxes.device)
        scale = torch.cat([size, size])
        return torch.clamp((boxes + scale / 2) / scale, 0.0, 1.0), torch.clamp((points + size / 2) / size, 0.0, 1.0)

    def _compute_object_encodings(self, observations, camera_rotations, camera_translations, bounding_boxes,
                                  reconstructed_boxes, shuffle_style: bool, train: bool, rng):
        """Style/deformation codes per object from the first camera: static
        objects crop their reconstructed boxes, dynamic ones the dataset
        boxes. With `shuffle_style`, each object's styles are permuted over
        T ("style_shuffle" stream), never by the identity.

        :return: ((B, T, O, S) style, (B, T, O, D) deformation, attention
            list, crops list).
        """
        b, t = observations.shape[:2]
        flat_obs = observations[:, :, 0].reshape((-1,) + observations.shape[-3:])
        flat_cam_rot = camera_rotations[:, :, 0].reshape(-1, 3)
        flat_cam_trans = camera_translations[:, :, 0].reshape(-1, 3)
        styles, deformations, attentions, crops_list = [], [], [], []
        for object_idx in range(self.object_ids.objects_count):
            model_idx = self.object_ids.model_idx_by_object_idx(object_idx)
            if self.object_ids.is_static_model(model_idx):
                boxes = reconstructed_boxes[:, :, 0, object_idx]
            else:
                boxes = bounding_boxes[:, :, 0, self.object_ids.dynamic_object_idx_by_object_idx(object_idx)]
            encoder = getattr(self, f"object_encoder_{model_idx}")
            style, deformation, attention, crops = encoder(
                flat_obs, boxes.reshape(-1, 4), flat_cam_rot, flat_cam_trans, train=train
            )
            style = style.reshape(b, t, -1)
            if shuffle_style and t > 1:
                perm = rng.permutation("style_shuffle", t)
                if bool((perm == torch.arange(t, device=perm.device)).all()):
                    perm = torch.roll(perm, 1)
                style = style[:, perm]
            styles.append(style)
            deformations.append(deformation.reshape(b, t, -1))
            attentions.append(attention.reshape((b, t) + attention.shape[1:]))
            crops_list.append(crops.reshape((b, t) + crops.shape[1:]))
        return torch.stack(styles, dim=2), torch.stack(deformations, dim=2), attentions, crops_list

    def compute_scene_encoding(
        self,
        observations: torch.Tensor,
        camera_rotations: torch.Tensor,
        camera_translations: torch.Tensor,
        focals: torch.Tensor,
        bounding_boxes: torch.Tensor,
        bounding_boxes_validity: torch.Tensor,
        global_frame_indexes: torch.Tensor,
        shuffle_style: bool = False,
        train: bool = True,
        rng=None,
    ) -> Tuple[SceneEncoding, Dict]:
        """Observations -> SceneEncoding plus auxiliary outputs.

        :param observations: (B, T, C, H, W, 3); camera_rotations /
            camera_translations (B, T, C, 3); focals (B, T, C) raw dataset
            focals; bounding_boxes (B, T, C, dynamic_objects, 4);
            bounding_boxes_validity (B, T, C, dynamic_objects) bool.
        :return: (SceneEncoding, aux with the reconstructed boxes, projected
            points, attention, crops, rescaled focals and matrices).
        """
        if shuffle_style and rng is None:
            raise ValueError("shuffle_style needs the random streams `rng`")
        height, width = observations.shape[-3], observations.shape[-2]
        rescaled_focals = focals * self.focal_length_multiplier
        c2w = euler_translation_to_matrix(camera_rotations, camera_translations)
        w2c = invert_rigid(c2w)
        object_rotations, object_translations = self._compute_object_poses(
            observations, w2c[:, :, 0], camera_rotations[:, :, 0], rescaled_focals[:, :, 0],
            bounding_boxes[:, :, 0], bounding_boxes_validity[:, :, 0], train,
        )
        o2w = euler_translation_to_matrix(object_rotations, object_translations)
        reconstructed_boxes, projected_points = self.compute_object_bounding_boxes(
            o2w, w2c.detach(), rescaled_focals.detach(), height, width
        )
        style, deformation, attention, crops = self._compute_object_encodings(
            observations, camera_rotations, camera_translations, bounding_boxes,
            reconstructed_boxes.detach(), shuffle_style, train, rng,
        )
        static_presence = torch.ones(
            bounding_boxes_validity.shape[:2] + (self.object_ids.static_objects_count,),
            dtype=torch.bool, device=bounding_boxes_validity.device,
        )
        object_in_scene = torch.cat([static_presence, bounding_boxes_validity.any(dim=2)], dim=-1)
        encoding = SceneEncoding(
            camera_rotations=camera_rotations, camera_translations=camera_translations, focals=focals,
            object_rotations=object_rotations, object_translations=object_translations,
            object_style=style, object_deformation=deformation, object_in_scene=object_in_scene,
        )
        aux = {
            "reconstructed_bounding_boxes": reconstructed_boxes,
            "reconstructed_3d_bounding_boxes": projected_points,
            "object_attention": attention,
            "object_crops": crops,
            "rescaled_focals": rescaled_focals,
            "c2w": c2w,
            "w2c": w2c,
            "o2w": o2w,
        }
        return encoding, aux

    # ---- rendering ---------------------------------------------------------

    def render_sampled_rays(self, encoding: SceneEncoding, sampled_directions: torch.Tensor,
                            perturb: bool = False, rng=None, step=0, canonical_pose: bool = False,
                            train: bool = True, compute_divergence: bool = False) -> Dict:
        """Render (B, T, C, n, 3) camera-frame directions through the scene."""
        c2w = euler_translation_to_matrix(encoding.camera_rotations, encoding.camera_translations)
        origins = torch.zeros_like(encoding.camera_rotations)
        normals = torch.zeros_like(origins)
        normals[..., 2] = -1.0
        origins, directions, normals = rays_lib.transform_rays(origins, sampled_directions, normals, c2w)
        w2o = invert_rigid(euler_translation_to_matrix(encoding.object_rotations, encoding.object_translations))
        cameras = sampled_directions.shape[2]

        def with_cameras(x):
            return x[:, :, None].expand(x.shape[:2] + (cameras,) + x.shape[2:])

        return self.composer(
            origins, directions, normals, with_cameras(w2o), with_cameras(encoding.object_style),
            with_cameras(encoding.object_deformation), with_cameras(encoding.object_in_scene),
            perturb=perturb, rng=rng, step=step, canonical_pose=canonical_pose,
            use_running_average=not train, compute_divergence=compute_divergence,
        )

    def forward_from_observations(
        self,
        observations: torch.Tensor,
        camera_rotations: torch.Tensor,
        camera_translations: torch.Tensor,
        focals: torch.Tensor,
        bounding_boxes: torch.Tensor,
        bounding_boxes_validity: torch.Tensor,
        global_frame_indexes: torch.Tensor,
        samples_per_image: int,
        perturb: bool = False,
        patch_size: int = 0,
        patch_strides: Optional[Sequence[int]] = None,
        shuffle_style: bool = False,
        step=0,
        canonical_pose: bool = False,
        train: bool = True,
        compute_divergence: bool = False,
        decode_patches: bool = False,
        rng=None,
    ) -> Dict:
        """The full training path: encode, sample rays, render and, with
        `decode_patches`, decode the rendered feature patches.

        Sampling: `patch_size > 0` -> one strided patch per image, its
        centre drawn from the object-weighted distribution; otherwise
        `samples_per_image == 0` with strides -> the whole-image strided
        grid; otherwise weighted (scene.use_weighted_sampling) or uniform
        rays. Draws come from the "ray_sampling" stream.
        """
        if decode_patches and (self.scene.autoencoder is None or not patch_size):
            raise ValueError("decode_patches requires scene.autoencoder and patch sampling")
        height, width = observations.shape[-3], observations.shape[-2]
        encoding, aux = self.compute_scene_encoding(
            observations, camera_rotations, camera_translations, focals, bounding_boxes,
            bounding_boxes_validity, global_frame_indexes, shuffle_style, train, rng,
        )
        ray_directions, _, _ = rays_lib.camera_rays(height, width, aux["rescaled_focals"])
        if patch_size:
            uniform = rng.uniform("ray_sampling", ray_directions.shape[:-3] + (1,))
            sampled = sampling.sample_rays_strided_patch(
                ray_directions, observations, patch_size, list(patch_strides),
                aux["reconstructed_bounding_boxes"].detach(), self.scene.sampling_weights, uniform,
            )
        elif samples_per_image == 0 and patch_strides:
            sampled = sampling.sample_all_rays_strided_grid(ray_directions, observations, list(patch_strides))
        elif self.scene.use_weighted_sampling:
            uniform = rng.uniform("ray_sampling", ray_directions.shape[:-3] + (samples_per_image,))
            sampled = sampling.sample_rays_weighted(
                ray_directions, observations, aux["reconstructed_bounding_boxes"].detach(),
                self.scene.sampling_weights, uniform,
            )
        else:
            indices = rng.randint("ray_sampling", height * width, ray_directions.shape[:-3] + (samples_per_image,))
            sampled = sampling.sample_rays_uniform(ray_directions, observations, indices)
        sampled_directions, sampled_observations, sampled_positions = sampled

        results = self.render_sampled_rays(
            encoding, sampled_directions, perturb=perturb, rng=rng, step=step,
            canonical_pose=canonical_pose, train=train, compute_divergence=compute_divergence,
        )
        c2w = aux["c2w"]
        origins = rays_lib.transform_points(torch.zeros_like(encoding.camera_rotations), c2w)
        world_directions = rays_lib.transform_points(sampled_directions, c2w[..., None, :, :], translate=False)
        results["ray_object_distances"] = self._ray_object_distances(origins, world_directions, aux["o2w"])
        if decode_patches:
            results = self.decode_rendered_patches(results, patch_size, train)
        results["observations"] = sampled_observations
        results["positions"] = sampled_positions
        results["scene_encoding"] = encoding
        for key in ("reconstructed_bounding_boxes", "reconstructed_3d_bounding_boxes",
                    "object_attention", "object_crops"):
            results[key] = aux[key]
        return results

    def decode_rendered_patches(self, results: Dict, patch_size: int, train: bool = True) -> Dict:
        """Decode the rendered feature patches into RGB patches: the
        features of each sample are the concatenated latent levels; per
        level, the samples of that level's strided patch are folded into a
        square patch, and the stack goes through the decoder. Adds to the
        "global" results "reconstructed_observations" (B, T, C, P, P, 3),
        P = patch_size * stride_0, and "splitted_integrated_features", the
        per-level feature samples."""
        strides = autoencoder_strides(self.scene.autoencoder)
        counts = features_count_by_layer(self.scene.autoencoder)
        global_results = results["coarse"]["global"]
        features = global_results["integrated_features"]
        patches, split_features, begin = [], [], 0
        for level_idx, count in enumerate(counts):
            chunk = sampling.split_strided_samples(features[..., begin : begin + count], patch_size, strides)[level_idx]
            begin += count
            split_features.append(chunk)
            patches.append(sampling.samples_to_patch(chunk))
        lead = patches[0].shape[:-3]
        decoded = self.autoencoder.decode([p.reshape((-1,) + p.shape[-3:]) for p in patches], train=train)
        global_results["reconstructed_observations"] = decoded.reshape(lead + decoded.shape[1:])
        global_results["splitted_integrated_features"] = split_features
        return results

    def _ray_object_distances(self, ray_origins, ray_directions, o2w) -> torch.Tensor:
        """Squared point-line distance between each ray and each object
        center: (B, T, C, n, O) for origins (B, T, C, 3), directions
        (B, T, C, n, 3) and o2w (B, T, O, 4, 4)."""
        unit_dirs = ray_directions / torch.linalg.norm(ray_directions, dim=-1, keepdim=True)
        distances = []
        for object_idx in range(self.object_ids.objects_count):
            cfg = self.scene.object_models[self.object_ids.model_idx_by_object_idx(object_idx)]
            box = torch.as_tensor(cfg.bounding_box, dtype=o2w.dtype, device=o2w.device)
            world_center = rays_lib.transform_points(bbox_lib.aabb_center(box), o2w[..., object_idx, :, :])
            rel = ray_origins[..., None, :] - world_center[..., None, None, :]
            along = torch.sum(rel * unit_dirs, dim=-1, keepdim=True) * unit_dirs
            distances.append(torch.sum((rel - along) ** 2, dim=-1))
        return torch.stack(distances, dim=-1)
