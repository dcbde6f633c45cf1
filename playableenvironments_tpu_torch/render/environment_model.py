"""EnvironmentModel: observations -> scene encoding -> rendered rays.

Port of the training path of
playableenvironments_tpu/render/environment_model.py: object poses from the
parameter strategies, projected object boxes, object style/deformation codes
from the object encoders (with the temporal style shuffle), the scene
encoding, ray sampling (weighted, uniform, the whole-image strided grid,
or one strided multi-resolution patch per image), the composed render
(with the hierarchical fine pass and the benders' divergence where asked),
the ray-to-object distances and, on the decoder path (`decode_patches`),
the autoencoder's decode of each pass's rendered feature patches; the
learnable per-frame camera offsets (`CameraParametersStorage`); the
composer-based frame render (`render_frame_from_scene_encoding`, the eval
path of a `use_fine` model, which render/fast.py does not take) and its
decode (`decode_rendered_grids`, or with the encoder's features mixed in,
`decode_mixed_grids`); the consistency passes
(`forward_pose_consistency`, `forward_keypoint_consistency`), which
resolve rays matched by optical flow or drawn along the keypoint skeleton
to expected surface positions. Random draws come from `rng`
(utils.random.RngStreams). `remat` rematerializes the composer's regions
and the decoder's blocks (utils/remat.py).
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


class CameraParametersStorage(nn.Module):
    """Per-(frame, camera) learnable camera corrections: 3 rotation + 3
    translation + 1 focal offsets in one zero-initialized (memory, cameras,
    7) table `storage`, gathered by frame index (clipped into the table),
    scaled (translations x10, focals x1000) for the optimizer's
    conditioning; zeros in eval mode."""

    def __init__(self, memory_size: int, cameras_count: int, device=None):
        super().__init__()
        self.memory_size = memory_size
        self.storage = nn.Parameter(torch.zeros(memory_size, cameras_count, 7, device=device))

    def forward(self, frame_indexes: torch.Tensor, train: bool = True):
        """:param frame_indexes: (...) integer frame indexes.
        :return: ((..., cameras, 3) rotation, (..., cameras, 3) translation
            and (..., cameras) focal offsets)."""
        idx = torch.clamp(frame_indexes.long(), 0, self.memory_size - 1)
        entries = self.storage[idx]
        if not train:
            entries = torch.zeros_like(entries)
        return entries[..., :3], entries[..., 3:6] * 10.0, entries[..., 6] * 1000.0


class EnvironmentModel(nn.Module):
    """The synthesis model's training surface: `composer`,
    `object_encoder_i`, for learned poses `parameters_encoder_i` and, where
    the scene has one, the full `autoencoder` (encoder and decoder, as the
    JAX model materializes both; the flax tree's names). The autoencoder
    takes a generator of its own seeded from `seed` + 1, decoder first, so
    that its decoder is the one the play session has always been seeded
    with and no other module's weights move. With `enable_camera_offsets`,
    `camera_offsets` holds the per-frame camera corrections of
    `camera_memory_size` frames and `training_cameras_count` cameras."""

    def __init__(self, scene: SceneConfig, focal_length_multiplier: float = 1.0,
                 enable_camera_offsets: bool = False, camera_memory_size: int = 1, training_cameras_count: int = 1,
                 device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.scene = scene
        self.focal_length_multiplier = focal_length_multiplier
        self.enable_camera_offsets = enable_camera_offsets
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
        if enable_camera_offsets:
            self.camera_offsets = CameraParametersStorage(camera_memory_size, training_cameras_count, device=device)

    # ---- scene encoding --------------------------------------------------

    def _apply_camera_offsets(self, camera_rotations, camera_translations, focals, global_frame_indexes,
                              train: bool):
        if not self.enable_camera_offsets:
            return camera_rotations, camera_translations, focals
        rotation, translation, focal = self.camera_offsets(global_frame_indexes, train)
        return camera_rotations + rotation, camera_translations + translation, focals + focal

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
        camera_rotations, camera_translations, focals = self._apply_camera_offsets(
            camera_rotations, camera_translations, focals, global_frame_indexes, train)
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
                            train: bool = True, compute_divergence: bool = False, remat: bool = False) -> Dict:
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
            use_running_average=not train, compute_divergence=compute_divergence, remat=remat,
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
        remat: bool = False,
    ) -> Dict:
        """The full training path: encode, sample rays, render and, with
        `decode_patches`, decode the rendered feature patches.

        Sampling: `patch_size > 0` -> one strided patch per image, its
        centre drawn from the object-weighted distribution; otherwise
        `samples_per_image == 0` with strides -> the whole-image strided
        grid; otherwise weighted (scene.use_weighted_sampling) or uniform
        rays. Draws come from the "ray_sampling" stream. `remat`
        rematerializes the composer's regions and the decoder's blocks.
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
            canonical_pose=canonical_pose, train=train, compute_divergence=compute_divergence, remat=remat,
        )
        c2w = aux["c2w"]
        origins = rays_lib.transform_points(torch.zeros_like(encoding.camera_rotations), c2w)
        world_directions = rays_lib.transform_points(sampled_directions, c2w[..., None, :, :], translate=False)
        results["ray_object_distances"] = self._ray_object_distances(origins, world_directions, aux["o2w"])
        if decode_patches:
            results = self.decode_rendered_patches(results, patch_size, train, remat)
        results["observations"] = sampled_observations
        results["positions"] = sampled_positions
        results["scene_encoding"] = encoding
        for key in ("reconstructed_bounding_boxes", "reconstructed_3d_bounding_boxes",
                    "object_attention", "object_crops"):
            results[key] = aux[key]
        return results

    def decode_rendered_patches(self, results: Dict, patch_size: int, train: bool = True,
                                remat: bool = False) -> Dict:
        """Decode each pass's rendered feature patches into RGB patches: the
        features of each sample are the concatenated latent levels; per
        level, the samples of that level's strided patch are folded into a
        square patch, and the stack goes through the decoder. Adds to each
        pass's "global" results "reconstructed_observations" (B, T, C, P, P,
        3), P = patch_size * stride_0, and "splitted_integrated_features",
        the per-level feature samples."""
        strides = autoencoder_strides(self.scene.autoencoder)
        counts = features_count_by_layer(self.scene.autoencoder)
        for pass_name in ("coarse", "fine"):
            if pass_name not in results:
                continue
            global_results = results[pass_name]["global"]
            features = global_results["integrated_features"]
            patches, split_features, begin = [], [], 0
            for level_idx, count in enumerate(counts):
                chunk = sampling.split_strided_samples(features[..., begin : begin + count], patch_size,
                                                       strides)[level_idx]
                begin += count
                split_features.append(chunk)
                patches.append(sampling.samples_to_patch(chunk))
            lead = patches[0].shape[:-3]
            decoded = self.autoencoder.decode([p.reshape((-1,) + p.shape[-3:]) for p in patches], train=train,
                                              remat=remat)
            global_results["reconstructed_observations"] = decoded.reshape(lead + decoded.shape[1:])
            global_results["splitted_integrated_features"] = split_features
        return results

    def render_frame_from_scene_encoding(self, encoding: SceneEncoding, image_size: Tuple[int, int],
                                         patch_strides: Optional[Sequence[int]] = None, ray_tile: int = 0,
                                         perturb: bool = False, rng=None, step=0, canonical_pose: bool = False,
                                         train: bool = False) -> Dict:
        """Render whole frames (on the strided feature grids with
        `patch_strides`, else every pixel) through the composer: the
        composer-based frame path, the only eval path of a `use_fine` model.
        With `ray_tile`, the rays go through the composer in tiles of that
        many, concatenated again (a memory bound the JAX function only
        hints at inside its program). Outside train mode no graph is kept.

        :return: composer results with the ray axis over the image grid
            (sampling.split_strided_grid_samples folds it back), and
            "positions" (..., n, 2).
        """
        height, width = image_size
        rescaled_focals = encoding.focals * self.focal_length_multiplier
        ray_directions, _, _ = rays_lib.camera_rays(height, width, rescaled_focals)
        if patch_strides:
            sampled_directions, _, sampled_positions = sampling.sample_all_rays_strided_grid(
                ray_directions, torch.zeros_like(ray_directions), list(patch_strides))
        else:
            n = height * width
            sampled_directions = ray_directions.reshape(ray_directions.shape[:-3] + (n, 3))
            sampled_positions = rays_lib.pixel_grid_positions(height, width, device=ray_directions.device).reshape(
                n, 2).expand(sampled_directions.shape[:-1] + (2,))

        def render(directions):
            return self.render_sampled_rays(encoding, directions, perturb=perturb, rng=rng, step=step,
                                            canonical_pose=canonical_pose, train=train)

        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            total = sampled_directions.shape[-2]
            if ray_tile and total > ray_tile:
                tiles = [render(sampled_directions[..., begin : begin + ray_tile, :])
                         for begin in range(0, total, ray_tile)]
                ray_axis = sampled_directions.dim() - 2
                results = _concatenate_tiles(tiles, ray_axis)
            else:
                results = render(sampled_directions)
        results["positions"] = sampled_positions
        return results

    def decode_rendered_grids(self, results: Dict, image_size: Tuple[int, int], train: bool = False) -> Dict:
        """Decode each pass's whole-image strided feature grids (rendered on
        `sample_all_rays_strided_grid` with the autoencoder's strides) into
        full frames: per level, its grid is folded to (H/s, W/s) and the
        decoder upsamples to full resolution. Adds "reconstructed_observations"
        (B, T, C, H, W, 3) to each pass's "global" results."""
        strides = autoencoder_strides(self.scene.autoencoder)
        counts = features_count_by_layer(self.scene.autoencoder)
        for pass_name in ("coarse", "fine"):
            if pass_name not in results:
                continue
            global_results = results[pass_name]["global"]
            features = global_results["integrated_features"]
            grids, begin = [], 0
            for level_idx, count in enumerate(counts):
                grids.append(sampling.split_strided_grid_samples(features[..., begin : begin + count], strides,
                                                                 image_size)[level_idx])
                begin += count
            lead = grids[0].shape[:-3]
            decoded = self.autoencoder.decode([g.reshape((-1,) + g.shape[-3:]) for g in grids], train=train)
            global_results["reconstructed_observations"] = decoded.reshape(lead + decoded.shape[1:])
        return results

    def decode_mixed_grids(self, observations: torch.Tensor, results: Dict, image_size: Tuple[int, int],
                           train: bool = False) -> Dict:
        """Decode whole-image grids with encoder-feature mixing: each level's
        VAE encoder mean of the ground-truth frames, with the rendered
        samples of that level written in at their cells
        (sampling.insert_samples_into_features), feeds the decoder (the
        reference's backpropagated-autoencoder variant; the published model
        decodes the rendered features alone, decode_rendered_grids). Adds
        "reconstructed_observations" (B, T, C, H, W, 3) to each pass's
        "global" results.

        :param observations: (B, T, C, H, W, 3) ground-truth frames.
        :param results: the renderer's output on `sample_all_rays_strided_grid`
            with the autoencoder's strides."""
        strides = autoencoder_strides(self.scene.autoencoder)
        counts = features_count_by_layer(self.scene.autoencoder)
        lead = observations.shape[:-3]
        encoded_levels = self.autoencoder.encode(observations.reshape((-1,) + observations.shape[-3:]), train)
        for pass_name in ("coarse", "fine"):
            if pass_name not in results:
                continue
            global_results = results[pass_name]["global"]
            features = global_results["integrated_features"]
            level_positions = sampling.split_strided_grid_samples(results["positions"], strides, image_size)
            mixed_levels, begin = [], 0
            for level_idx, (count, level) in enumerate(zip(counts, encoded_levels)):
                mean = level[..., : level.shape[-1] // 2]  # levels are mean ++ log variance
                samples = sampling.split_strided_grid_samples(features[..., begin : begin + count], strides,
                                                              image_size)[level_idx]
                begin += count
                mixed_levels.append(sampling.insert_samples_into_features(
                    mean, samples.reshape(mean.shape[0], -1, samples.shape[-1]),
                    level_positions[level_idx].reshape(mean.shape[0], -1, 2), image_size))
            decoded = self.autoencoder.decode(mixed_levels, train=train)
            global_results["reconstructed_observations"] = decoded.reshape(lead + decoded.shape[1:])
        return results

    # ---- consistency passes ------------------------------------------------

    def _consistency_geometry(self, encoding: SceneEncoding, image_size: Tuple[int, int]):
        """(ray directions (B, T, C, H, W, 3) in the camera frame, zero
        origins and -z focal normals (B, T, C, 3), c2w (B, T, C, 4, 4), w2o
        (B, T, O, 4, 4)) of an encoding."""
        height, width = image_size
        directions, _, _ = rays_lib.camera_rays(height, width, encoding.focals * self.focal_length_multiplier)
        origins = torch.zeros_like(encoding.camera_rotations)
        normals = torch.zeros_like(origins)
        normals[..., 2] = -1.0
        c2w = euler_translation_to_matrix(encoding.camera_rotations, encoding.camera_translations)
        w2o = invert_rigid(euler_translation_to_matrix(encoding.object_rotations, encoding.object_translations))
        return directions, origins, normals, c2w, w2o

    def _object_codes(self, encoding: SceneEncoding, w2o, object_idx: int):
        """One object's w2o and deformation with a camera axis of 1."""
        return (w2o[..., object_idx, :, :][:, :, None],
                encoding.object_deformation[..., object_idx, :][:, :, None])

    def forward_pose_consistency(
        self,
        encoding: SceneEncoding,
        optical_flow: torch.Tensor,
        bounding_boxes: torch.Tensor,
        bounding_boxes_validity: torch.Tensor,
        samples_per_image: int,
        perturb: bool = False,
        rng=None,
        step=0,
    ) -> Dict:
        """Expected-position pairs matched by optical flow for every dynamic
        object: rays drawn inside the object's box in frame t, moved by the
        flow into frame t + 1 (positions are pixel / side where the
        align-corners sample maps p (side - 1): a skew of up to one pixel,
        kept as the reference has it), both resolved by
        SceneComposer.forward_expected_positions, one call each (alphas
        and displacements only: no running statistic moves, and JAX's
        `train` changes nothing the pass returns, so the port has none).

        Draws, per dynamic object: "sampling" (the box draw), then for the
        frame-t call and the frame-t+1 call in turn, with `perturb`,
        "sampling" (the strata) and "alpha_noise".

        :param optical_flow: (B, T, C, H, W, 2) normalized (d_row, d_col).
        :param bounding_boxes: (B, T, C, dynamic_objects, 4) normalized ltrb.
        :param bounding_boxes_validity: (B, T, C, dynamic_objects) bool.
        :return: {"coarse": {"dynamic_object_i": (previous (B, T-1, C, n, 3),
            next (B, T-1, C, n, 3), pair validity (B, T-1, C))}}.
        """
        height, width = optical_flow.shape[-3], optical_flow.shape[-2]
        directions, origins, normals, c2w, w2o = self._consistency_geometry(encoding, (height, width))
        static = self.object_ids.static_objects_count
        results = {"coarse": {}}
        for dynamic_idx in range(self.object_ids.dynamic_objects_count):
            object_idx = static + dynamic_idx
            box = bounding_boxes[..., dynamic_idx, :]
            validity = bounding_boxes_validity[..., dynamic_idx]
            w2o_obj, deformation = self._object_codes(encoding, w2o, object_idx)
            uniform = rng.uniform("sampling", box[:, :-1].shape[:-1] + (samples_per_image,))
            prev_dirs, prev_flow, prev_positions = sampling.sample_rays_at_object(
                directions[:, :-1], optical_flow[:, :-1], box[:, :-1], uniform)
            next_dirs = sampling.sample_at_positions(directions[:, 1:], prev_positions + prev_flow)
            expected = []
            for frames, dirs in ((slice(None, -1), prev_dirs), (slice(1, None), next_dirs)):
                ray_o, ray_d, ray_n = rays_lib.transform_rays(origins[:, frames], dirs, normals[:, frames],
                                                              c2w[:, frames])
                expected.append(self.composer.forward_expected_positions(
                    object_idx, ray_o, ray_d, ray_n, w2o_obj[:, frames], deformation[:, frames], validity[:, frames],
                    perturb=perturb, rng=rng, step=step,
                )["coarse"][0])
            results["coarse"][f"dynamic_object_{dynamic_idx}"] = (
                expected[0], expected[1], validity[:, :-1] & validity[:, 1:])
        return results

    def forward_keypoint_consistency(
        self,
        encoding: SceneEncoding,
        keypoints: torch.Tensor,
        keypoints_validity: torch.Tensor,
        image_size: Tuple[int, int],
        max_samples_per_image: int,
        perturb: bool = False,
        rng=None,
        step=0,
    ) -> Dict:
        """Keypoint-anchored expected positions for every dynamic object:
        rays through random points of the COCO skeleton, the same body point
        in every observation and camera, resolved by one
        SceneComposer.forward_expected_positions call (as in
        forward_pose_consistency: no running statistic moves, no `train`).

        Draws, per dynamic object: "sampling" (the fractions along the
        segments, (B, 1, 1, n, 1)), then, with `perturb`, "sampling" (the
        strata) and "alpha_noise".

        :param keypoints: (B, T, C, K, 3, dynamic_objects) normalized (row,
            col, confidence).
        :param keypoints_validity: (B, T, C, dynamic_objects) bool.
        :return: {"coarse": {"dynamic_object_i": (expected (B, T, C, n, 3),
            confidence (B, T, C, n), opacity (B, T, C, n), positions
            (B, T, C, n, 2))}}.
        """
        directions, origins, normals, c2w, w2o = self._consistency_geometry(encoding, image_size)
        static = self.object_ids.static_objects_count
        results = {"coarse": {}}
        for dynamic_idx in range(self.object_ids.dynamic_objects_count):
            object_idx = static + dynamic_idx
            object_keypoints = keypoints[..., dynamic_idx]
            validity = keypoints_validity[..., dynamic_idx]
            w2o_obj, deformation = self._object_codes(encoding, w2o, object_idx)
            uniform = rng.uniform("sampling", object_keypoints.shape[:-4] + (1, 1, max_samples_per_image, 1))
            sampled_dirs, positions, confidence = sampling.sample_rays_at_keypoints(
                directions, object_keypoints, uniform)
            confidence = confidence * validity[..., None]
            ray_o, ray_d, ray_n = rays_lib.transform_rays(origins, sampled_dirs, normals, c2w)
            expected, opacity = self.composer.forward_expected_positions(
                object_idx, ray_o, ray_d, ray_n, w2o_obj, deformation, validity, perturb=perturb, rng=rng, step=step,
            )["coarse"]
            results["coarse"][f"dynamic_object_{dynamic_idx}"] = (expected, confidence, opacity, positions)
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


def _concatenate_tiles(tiles, axis: int):
    """The tiles' result trees (nested dicts of tensors) joined along `axis`
    of the rays, as `jax.tree.map(concatenate, *tiles)`."""
    first = tiles[0]
    if isinstance(first, dict):
        return {k: _concatenate_tiles([t[k] for t in tiles], axis) for k in first}
    return torch.cat(tiles, dim=axis)
