"""Eval-mode frame rendering: per-object compacted ray domains, the fused
NeRF MLP kernel (one grouped launch for the objects of each NeRF
configuration), sort-free compositing across objects, and the
multiresolution decode.

Port of playableenvironments_tpu/render/fast.py (`_bender_displacements`,
`render_rays_fast`, `render_frame_fast`, and `_render_rays_fast_sharded`
as `render_rays_fast_sharded`: the eval ray split over a device mesh). Semantics match the
JAX function step by step, including the stable hits-first compaction and
its truncation at the budget, the `big` / 1e10 sentinels and the log-space
1 - alpha. The skybox runs its MLP once per ray, outside the kernel groups;
the Minecraft overlap fix (`fix_object_overlaps`) suppresses static samples
inside a dynamic object's interval, after which those objects' samples are
no longer sorted in t and their successors come from a masked minimum.
"""

from __future__ import annotations

import copy
import math
import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch

from playableenvironments_tpu_torch.config import ObjectIds, SceneConfig
from playableenvironments_tpu_torch.core import bbox as bbox_lib
from playableenvironments_tpu_torch.core import compositing
from playableenvironments_tpu_torch.core import rays as rays_lib
from playableenvironments_tpu_torch.core.transforms3d import (
    euler_translation_to_matrix,
    invert_rigid,
)
from playableenvironments_tpu_torch.models.encoding import (
    annealing_weights,
    positional_encoding,
)
from playableenvironments_tpu_torch.ops import fused_nerf
from playableenvironments_tpu_torch.render import sampling

# "No successor" fill for the successor-t minimum and the distance that
# replaces it (the last sample's interval, as in the reference).
BIG = compositing.BIG
LAST_DISTANCE = compositing.LAST_DISTANCE


def _bender_displacements(cfg, bender, positions, deformation, step):
    """PositionalRayBender forward in f32, clamped into the bbox.

    :param cfg: ObjectModelConfig; :param bender: models.nerf.PositionalRayBender.
    :param step: PE annealing step; at step 0 every octave weight is 0.
    """
    box = torch.as_tensor(cfg.bounding_box, dtype=positions.dtype, device=positions.device)
    size = box[:, 1] - box[:, 0]
    pe_cfg = cfg.bender.position_encoder
    weights = (
        annealing_weights(pe_cfg.octaves, step, pe_cfg.num_steps, device=positions.device)
        if pe_cfg.num_steps
        else None
    )
    enc = positional_encoding(positions / size, pe_cfg.octaves, pe_cfg.append_original, weights)
    deformation = deformation.expand(positions.shape[:-1] + deformation.shape[-1:])
    inputs = torch.cat([enc, deformation], dim=-1)
    h = inputs
    for i in range(cfg.bender.layers_count):
        if i == cfg.bender.skip_layer_idx:
            h = torch.cat([h, inputs], dim=-1)
        layer = getattr(bender, f"backbone_{i}")
        h = torch.relu(h @ layer.weight.t() + layer.bias)
    displacements = (h @ bender.output_head.weight.t()) * size
    return torch.minimum(torch.maximum(displacements, box[:, 0] - positions), box[:, 1] - positions)


def hits_first_order(hit: torch.Tensor, budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable hits-first partition of each row's rays, truncated at `budget`.

    Hit rays keep their order at the front, misses fill the tail, and rays
    past the budget are dropped (hits beyond it included).

    :param hit: (L, R) bool.
    :return: ((L, budget) ray index per compacted slot, (L, R) compacted slot
        per ray, `budget` for rays that were dropped).
    """
    l, rays = hit.shape
    hit_i = hit.to(torch.int64)
    hits_total = hit_i.sum(dim=-1, keepdim=True)
    slot = torch.where(
        hit,
        torch.cumsum(hit_i, dim=-1) - 1,
        hits_total + torch.cumsum(1 - hit_i, dim=-1) - 1,
    )
    ray_ids = torch.arange(rays, device=hit.device).expand(l, rays)
    order = torch.zeros_like(slot).scatter_(1, slot, ray_ids)[:, :budget]
    inv = torch.full_like(slot, budget)
    inv.scatter_(1, order, torch.arange(budget, device=hit.device).expand(l, budget))
    return order, inv


def sample_alphas(raw_alpha, next_t, t, dir_norm):
    """Alphas and log(1 - alpha + 1e-10) of samples at `t` whose successor
    (over all objects) is at `next_t` (BIG where there is none).

    The log is taken as logaddexp(-x, log(1e-10)): forming 1 - alpha first
    rounds to 0 for x above ~17 and loses the exp(-x) term entirely.
    """
    deltas = torch.where(next_t >= BIG, LAST_DISTANCE, next_t - t)
    x = torch.relu(raw_alpha) * (deltas * dir_norm[..., None])
    log_eps = torch.log(torch.tensor(1e-10, dtype=x.dtype, device=x.device))
    return 1.0 - torch.exp(-x), torch.logaddexp(-x, log_eps)


def _gather_rays(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """values[b, order[b, j], ...] for (L, R, ...) values and (L, B) order."""
    index = order.reshape(order.shape + (1,) * (values.dim() - 2))
    return torch.take_along_dim(values, index, dim=1)


def _scatter_rays(target: torch.Tensor, order: torch.Tensor, values: torch.Tensor, add: bool):
    index = order[..., None].expand(values.shape)
    return target.scatter_add_(1, index, values) if add else target.scatter_(1, index, values)


def _next_within(t_a: torch.Tensor) -> torch.Tensor:
    """Successor t within one object's own samples, robust to unsorted t:
    the minimum over the samples after each one in (t, index) order, BIG
    where there is none. Equals t[i + 1] where t is ascending."""
    idx = torch.arange(t_a.shape[-1], device=t_a.device)
    ti, tj = t_a[..., :, None], t_a[..., None, :]
    later = (tj > ti) | ((tj == ti) & (idx[None, :] > idx[:, None]))
    return torch.where(later, tj, torch.full_like(tj, BIG)).amin(dim=-1)


def object_samples(cfg, origins, dirs, normals, w2o, in_scene):
    """One object's ray geometry: the rays in its frame, whether they hit
    its box, and the deterministic (perturb off) sample distances.

    :param origins: (L, 3); dirs (L, R, 3); normals (L, 3); w2o (L, 4, 4);
        in_scene (L,).
    :return: ((L, 3) object-frame origins, (L, R, 3) directions, (L, R) hit,
        (L, R, S) sample t).
    """
    box = torch.as_tensor(cfg.bounding_box, dtype=dirs.dtype, device=dirs.device)
    samples = cfg.positions_count_coarse
    o_origins, o_dirs, _ = rays_lib.transform_rays(origins, dirs, normals, w2o)
    z_near, z_far = bbox_lib.ray_aabb_bounds(o_origins, o_dirs, box, in_scene)
    hit = z_far > z_near
    z_near = torch.clamp(z_near, cfg.z_near_min, cfg.z_far_max)
    z_far = torch.clamp(z_far, cfg.z_near_min, cfg.z_far_max)
    # The f32 linspace of the JAX package: i / (S - 1), endpoints exact.
    fractions = torch.arange(samples, dtype=dirs.dtype, device=dirs.device) / max(samples - 1, 1)
    return o_origins, o_dirs, hit, z_near[..., None] + (z_far - z_near)[..., None] * fractions


def _min_after(t_a, t_b, a_first: bool):
    """min over t_b strictly after each t_a in (t, object index) order; BIG
    where there is none. `a_first`: ties go after (t_a's object comes first)."""
    ti, tj = t_a[..., :, None], t_b[..., None, :]
    after = (tj > ti) | (tj == ti) if a_first else tj > ti
    return torch.where(after, tj, torch.full_like(tj, BIG)).amin(dim=-1)


@torch.no_grad()
def render_rays_fast(
    scene: SceneConfig,
    composer,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    focal_normals: torch.Tensor,
    w2o_matrices: torch.Tensor,
    style: torch.Tensor,
    deformation: torch.Tensor,
    object_in_scene: torch.Tensor,
    step=0,
) -> Dict:
    """Eval-mode composed render in per-object compacted ray domains.

    For each object the rays hitting its AABB are compacted into a budget of
    `ray_compaction` x rays; the MLP, the alphas and the per-object
    integration run there, and only per-ray integrals scatter back. Objects
    composite sort-free: each sample's successor and transmittance come from
    masked minima and sums over the other objects' samples on the same ray.
    With `fix_object_overlaps`, static objects (which must not be compacted;
    ValueError otherwise) lose the samples inside each dynamic object's t
    interval (alpha -10, t 0), as in the JAX function.

    :param composer: render.composer.SceneComposer (the weights).
    :param ray_origins: (..., 3); ray_directions (..., rays, 3);
        focal_normals (..., 3); w2o_matrices (..., objects, 4, 4);
        style / deformation (..., objects, F); object_in_scene (..., objects).
    :return: {"coarse": {"global": {...}, "object_i": {...}}} with
        integrated_features (..., rays, F), opacity, depth, disparity,
        integrated_displacements_magnitude, integrated_divergence (..., rays).
    """
    object_ids = ObjectIds(scene)
    if any(om.use_fine for om in scene.object_models):
        raise NotImplementedError(
            "render.fast is coarse-only; use SceneComposer for use_fine "
            "objects (or set use_fine=False for interactive rendering)"
        )

    lead = tuple(ray_directions.shape[:-2])
    rays = ray_directions.shape[-2]
    l = math.prod(lead)
    objects = object_ids.objects_count
    device, dtype = ray_directions.device, ray_directions.dtype

    dirs = ray_directions.reshape(l, rays, 3)
    dir_norm = torch.linalg.norm(dirs, dim=-1)  # (L, R)
    origins_f = ray_origins.expand(lead + (3,)).reshape(l, 3)
    normals_f = focal_normals.expand(lead + (3,)).reshape(l, 3)
    w2o_f = w2o_matrices.expand(lead + (objects, 4, 4)).reshape(l, objects, 4, 4)
    style_f = style.expand(lead + tuple(style.shape[-2:])).reshape((l,) + tuple(style.shape[-2:]))
    deform_f = deformation.expand(lead + tuple(deformation.shape[-2:])).reshape(
        (l,) + tuple(deformation.shape[-2:])
    )
    in_scene_f = object_in_scene.expand(lead + (objects,)).reshape(l, objects)

    # ---- Phase 1: per-object geometry and compaction, then the fields of
    # all AdaIN objects of one NeRF configuration in one grouped MLP call;
    # the skybox per ray, with plain products ---------------------------------
    per, fields, evaluated = [], {}, {}
    for object_idx in range(objects):
        model_idx = object_ids.model_idx_by_object_idx(object_idx)
        cfg = scene.object_models[model_idx]
        field = composer.object_model(model_idx)
        box = torch.as_tensor(cfg.bounding_box, dtype=dtype, device=device)
        samples = cfg.positions_count_coarse
        o_origins, o_dirs, hit, t_full = object_samples(
            cfg, origins_f, dirs, normals_f, w2o_f[:, object_idx], in_scene_f[:, object_idx]
        )

        compact = cfg.ray_compaction < 1.0
        budget = max(int(rays * cfg.ray_compaction), 1) if compact else rays
        if compact:
            order, inv = hits_first_order(hit, budget)
            packed = _gather_rays(torch.cat([t_full, o_dirs, dir_norm[..., None]], dim=-1), order)
            t_c = packed[..., :samples]
            o_dirs_c = packed[..., samples : samples + 3]
            dirn_c = packed[..., samples + 3]
        else:
            order = torch.arange(rays, device=device).expand(l, rays)
            inv = None  # read only for compacted objects
            t_c, o_dirs_c, dirn_c = t_full, o_dirs, dir_norm
        o_origins_c = o_origins[:, None].expand(l, budget, 3)
        positions_c = o_origins_c[..., None, :] + t_c[..., None] * o_dirs_c[..., None, :]

        obj_style = style_f[:, object_idx]
        obj_deform = deform_f[:, object_idx]
        in_box = bbox_lib.aabb_contains(box, positions_c)

        if cfg.bender.kind == "positional":
            disp_c = _bender_displacements(
                cfg, field.ray_bender, positions_c, obj_deform[:, None, None], step
            )
            disp_c = torch.where(in_box[..., None], disp_c, 0.0)
            eval_positions = positions_c + disp_c
        else:
            disp_c = torch.zeros_like(positions_c)
            eval_positions = positions_c

        if cfg.nerf.kind == "skybox":
            # Constant along each ray; running statistics, so the mask of
            # rays with a sample in the box feeds no statistic.
            feats_ray, alpha_ray = field.nerf(
                o_origins_c, o_dirs_c, cfg.bounding_box, obj_style[:, None], in_box.any(dim=-1), True
            )
            evaluated[object_idx] = (
                feats_ray[..., None, :].expand(l, budget, samples, feats_ray.shape[-1]),
                alpha_ray[..., None].expand(l, budget, samples),
            )
        else:
            style_points = obj_style[:, None, None].expand(l, budget, 1, obj_style.shape[-1])
            fields.setdefault(cfg.nerf, []).append((object_idx, fused_nerf.ObjectField(
                cfg.bounding_box, field.nerf, eval_positions, style_points, cfg.empty_space_alpha,
            )))
        per.append({
            "order": order, "inv": inv, "budget": budget, "compact": compact, "t_full": t_full,
            "t_c": t_c, "in_box": in_box, "disp_c": disp_c, "dirn_c": dirn_c, "o_origins_c": o_origins_c,
            "unsorted": False,
        })

    for nerf_cfg, group in fields.items():
        outputs = fused_nerf.fused_object_field_eval_group(nerf_cfg, [f for _, f in group])
        evaluated.update(zip((object_idx for object_idx, _ in group), outputs))

    for object_idx, entry in enumerate(per):
        cfg = scene.object_models[object_ids.model_idx_by_object_idx(object_idx)]
        feats_c, alpha_c = evaluated[object_idx]
        in_box = entry.pop("in_box")

        # Empty-space masking on the unbent positions, and absent objects.
        feats_c = torch.where(in_box[..., None], feats_c, 0.0)
        alpha_c = torch.where(in_box, alpha_c, cfg.empty_space_alpha)
        alpha_c = torch.where(
            in_scene_f[:, object_idx][:, None, None], alpha_c, cfg.empty_space_alpha
        )
        if scene.apply_activation:
            feats_c = torch.sigmoid(feats_c)
        entry["raw_alpha_c"], entry["feats_c"] = alpha_c, feats_c

    # ---- The overlap fix (Minecraft): full-domain static objects only. The
    # masked samples' t becomes 0 mid-array, so these objects' samples are
    # no longer sorted: their own successors come from _next_within.
    if scene.fix_object_overlaps:
        static_count = object_ids.static_objects_count
        for entry in per[:static_count]:
            if entry["compact"]:
                raise ValueError(
                    "fix_object_overlaps requires ray_compaction=1.0 on static objects (their samples are "
                    "masked by dynamic objects' intervals over the full ray set)"
                )
            mask = torch.zeros_like(entry["t_c"], dtype=torch.bool)
            for other in per[static_count:]:
                mask |= compositing.overlap_fix_mask(entry["t_c"], other["t_full"])
            disp = entry["disp_c"]
            entry["raw_alpha_c"], entry["t_c"], _, entry["disp_c"], _ = compositing.apply_overlap_fix(
                entry["raw_alpha_c"], entry["t_c"], torch.zeros_like(disp), disp,
                torch.zeros_like(entry["t_c"]), entry["o_origins_c"], mask,
            )
            entry["t_full"] = entry["t_c"]  # full domain == compacted domain here
            entry["unsorted"] = True

    # ---- Phase 2: successor distances + alphas per object ----------------
    # Total order = (t, object index) lexicographic. Other objects' t comes
    # from their full-ray geometry at this object's compacted rays.
    t_b_at = {}
    for a, entry in enumerate(per):
        t_a = entry["t_c"]
        if entry["unsorted"]:
            # Kept for the object's own integration in phase 3.
            own_next = entry["own_next"] = _next_within(t_a)
        else:
            own_next = torch.cat([t_a[..., 1:], torch.full_like(t_a[..., :1], BIG)], dim=-1)
        candidates = [own_next]
        for b, other in enumerate(per):
            if b == a:
                continue
            t_b = _gather_rays(other["t_full"], entry["order"]) if entry["compact"] else other["t_full"]
            t_b_at[(a, b)] = t_b
            candidates.append(_min_after(t_a, t_b, a_first=a < b))
        next_t = torch.stack(candidates, dim=0).amin(dim=0)
        entry["alphas_c"], entry["log1m_c"] = sample_alphas(
            entry["raw_alpha_c"], next_t, t_a, entry["dirn_c"]
        )

    # ---- Phase 3: transmittance, weights, scattered integrals ------------
    features_count = per[0]["feats_c"].shape[-1]
    total_samples = sum(e["t_c"].shape[-1] for e in per)
    global_packed = torch.zeros((l, rays, features_count + 3), dtype=dtype, device=device)

    def exclusive_cumsum(values):
        cs = torch.cumsum(values, dim=-1)
        return torch.cat([torch.zeros_like(cs[..., :1]), cs[..., :-1]], dim=-1)

    results = {"coarse": {}}
    for a, entry in enumerate(per):
        t_a = entry["t_c"]
        transmittance_log = exclusive_cumsum(entry["log1m_c"])
        for b, other in enumerate(per):
            if b == a:
                continue
            # Object b's per-sample log mass at this object's rays.
            if other["compact"]:
                idx_b = _gather_rays(other["inv"], entry["order"]) if entry["compact"] else other["inv"]
                valid = idx_b < other["budget"]
                gathered = _gather_rays(other["log1m_c"], idx_b.clamp(0, other["budget"] - 1))
                log1m_b = torch.where(valid[..., None], gathered, 0.0)
            elif entry["compact"]:
                log1m_b = _gather_rays(other["log1m_c"], entry["order"])
            else:
                log1m_b = other["log1m_c"]
            ti, tj = t_a[..., :, None], t_b_at[(a, b)][..., None, :]
            before = (tj < ti) | (tj == ti) if b < a else tj < ti
            transmittance_log = transmittance_log + torch.where(
                before, log1m_b[..., None, :], 0.0
            ).sum(dim=-1)
        weights = entry["alphas_c"] * torch.exp(transmittance_log)

        disp_norm = torch.linalg.norm(entry["disp_c"], dim=-1)
        packed_contrib = torch.cat(
            [
                (weights[..., None] * entry["feats_c"]).sum(dim=-2),
                weights.sum(dim=-1)[..., None],
                (weights * t_a).sum(dim=-1)[..., None],
                (weights * disp_norm).sum(dim=-1)[..., None],
            ],
            dim=-1,
        )
        _scatter_rays(global_packed, entry["order"], packed_contrib, add=True)

        # Per-object integration with its own sample spacing.
        if entry["unsorted"]:
            own_next = entry["own_next"]
            own_dist = torch.where(own_next >= BIG, LAST_DISTANCE, own_next - t_a)
        else:
            own_dist = torch.cat(
                [t_a[..., 1:] - t_a[..., :-1], torch.full_like(t_a[..., :1], LAST_DISTANCE)], dim=-1
            )
        own_dist = own_dist * entry["dirn_c"][..., None]
        own_alphas = 1.0 - torch.exp(-torch.relu(entry["raw_alpha_c"]) * own_dist)
        own_weights = compositing.compositing_weights(own_alphas)
        packed_obj = torch.cat(
            [
                (own_weights[..., None] * entry["feats_c"]).sum(dim=-2),
                own_weights.sum(dim=-1)[..., None],
                (own_weights * t_a).sum(dim=-1)[..., None],
                (own_weights * disp_norm).mean(dim=-1)[..., None],
            ],
            dim=-1,
        )
        scattered = _scatter_rays(
            torch.zeros((l, rays, features_count + 3), dtype=dtype, device=device),
            entry["order"], packed_obj, add=False,
        )
        results["coarse"][f"object_{a}"] = _integrals(scattered, features_count, lead, rays)

    results["coarse"]["global"] = _integrals(
        global_packed, features_count, lead, rays, disp_divisor=total_samples
    )
    return results


def _integrals(packed, features_count, lead, rays, disp_divisor=None) -> Dict:
    """Unpack (L, R, F + 3) features ++ (opacity, depth, displacement) into
    the integrate-style result dict; disparity follows from opacity/depth."""
    opacity = packed[..., features_count]
    depth = packed[..., features_count + 1]
    disp = packed[..., features_count + 2]
    if disp_divisor is not None:
        disp = disp / disp_divisor
    disparity = 1.0 / torch.clamp(depth / torch.clamp(opacity, min=1e-10), min=1e-10)
    return {
        "integrated_features": packed[..., :features_count].reshape(lead + (rays, features_count)),
        "opacity": opacity.reshape(lead + (rays,)),
        "depth": depth.reshape(lead + (rays,)),
        "disparity": disparity.reshape(lead + (rays,)),
        "integrated_displacements_magnitude": disp.reshape(lead + (rays,)),
        "integrated_divergence": torch.zeros(lead + (rays,), dtype=packed.dtype, device=packed.device),
    }


_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _composer_on(composer, device: torch.device):
    """`composer` where it lies on `device`, else a copy of it there, made
    again after any of its parameters changes."""
    if next(composer.parameters()).device == device:
        return composer
    key = tuple((p.data_ptr(), p._version) for p in composer.parameters())
    replicas = _REPLICAS.setdefault(composer, {})
    if device not in replicas or replicas[device][0] != key:
        replicas[device] = (key, copy.deepcopy(composer).to(device))
    return replicas[device][1]


def _map_results(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_results(fn, v) for k, v in tree.items()}
    return fn(tree)


def _concat_results(trees, lead_ndim: int, axis_of_batch: bool):
    """Leaf-wise concatenation of render_rays_fast results: along the batch
    axis, or along the ray axis, which follows the `lead_ndim` leading axes
    in every leaf ((..., rays, F) and (..., rays))."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _concat_results([t[k] for t in trees], lead_ndim, axis_of_batch) for k in first}
    return torch.cat(trees, dim=0 if axis_of_batch else lead_ndim)


@torch.no_grad()
def render_rays_fast_sharded(
    mesh,
    scene: SceneConfig,
    composer,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    focal_normals: torch.Tensor,
    w2o_matrices: torch.Tensor,
    style: torch.Tensor,
    deformation: torch.Tensor,
    object_in_scene: torch.Tensor,
    step=0,
) -> Dict:
    """render_rays_fast over a parallel.mesh.DeviceMesh (data, rays), in one
    process: the port of the JAX package's `_render_rays_fast_sharded`
    (render/fast.py:560-673), whose shard_map runs the fused kernel on each
    device's ray slice. Here ray slice k of batch rows d renders on
    `mesh.device(d, k)` (one grouped B1 launch a slice on the card; the
    composer copied to a device it does not lie on), and the per-ray
    outputs are concatenated on the rays' device. The ray axis is padded to
    a multiple of `rays` with unit-z rays, which render ordinary values
    that are cut off. A batch that does not divide the data axis is not
    split over it, with the JAX package's warning (JAX computes it on every
    data row; here the first row's devices render it once).

    :param ray_origins...: as render_rays_fast, leading dims (B, ...).
    """
    rays_size = mesh.rays
    batch = ray_directions.shape[0]
    split_data = mesh.data > 1 and batch % mesh.data == 0
    if mesh.data > 1 and not split_data:
        import warnings

        warnings.warn(
            f"render_rays_fast_sharded: batch {batch} does not divide the mesh data axis ({mesh.data}); the batch "
            "is replicated on every data row (wasted compute). Size the eval batch to the data axis or set "
            "evaluation.mesh data: 1.",
            stacklevel=2,
        )
    home = ray_directions.device
    rays = ray_directions.shape[-2]
    pad = (-rays) % rays_size
    if pad:
        filler = torch.zeros(ray_directions.shape[:-2] + (pad, 3), dtype=ray_directions.dtype, device=home)
        filler[..., 2] = 1.0
        ray_directions = torch.cat([ray_directions, filler], dim=-2)
    per_slice = ray_directions.shape[-2] // rays_size
    lead_ndim = ray_directions.dim() - 2
    local = batch // mesh.data if split_data else batch
    row_results = []
    for d in range(mesh.data if split_data else 1):
        rows = slice(d * local, (d + 1) * local)
        slices = []
        for k in range(rays_size):
            device = mesh.device(d, k)
            args = [x[rows].to(device) for x in (ray_origins, ray_directions[..., k * per_slice:(k + 1) * per_slice, :],
                                                 focal_normals, w2o_matrices, style, deformation, object_in_scene)]
            out = render_rays_fast(scene, _composer_on(composer, device), *args, step=step)
            slices.append(_map_results(lambda x: x.to(home), out))
        row_results.append(_concat_results(slices, lead_ndim, axis_of_batch=False))
    results = _concat_results(row_results, lead_ndim, axis_of_batch=True)
    if pad:
        results = _map_results(lambda x: x[..., :rays, :] if x.dim() == lead_ndim + 2 else x[..., :rays], results)
    return results


def frame_rays(
    encoding,
    image_size: Tuple[int, int],
    patch_strides: Optional[Sequence[int]] = None,
    focal_length_multiplier: float = 1.0,
):
    """render_rays_fast's inputs for a full frame of `encoding`: the camera
    rays (strided grids when `patch_strides` is given) in world space, and
    each object's world-to-object transform and codes per camera.

    :return: (origins, directions, normals, w2o, style, deformation,
        object_in_scene), leading dims (B, T, C).
    """
    height, width = image_size
    ray_directions, _, _ = rays_lib.camera_rays(
        height, width, encoding.focals * focal_length_multiplier
    )
    if patch_strides:
        sampled_directions, _, _ = sampling.sample_all_rays_strided_grid(
            ray_directions, torch.zeros_like(ray_directions), list(patch_strides)
        )
    else:
        sampled_directions = ray_directions.reshape(ray_directions.shape[:-3] + (height * width, 3))

    c2w = euler_translation_to_matrix(encoding.camera_rotations, encoding.camera_translations)
    origins = torch.zeros_like(encoding.camera_rotations)
    normals = torch.zeros_like(origins)
    normals[..., 2] = -1.0
    origins, directions, normals = rays_lib.transform_rays(origins, sampled_directions, normals, c2w)

    w2o = invert_rigid(
        euler_translation_to_matrix(encoding.object_rotations, encoding.object_translations)
    )
    cameras = sampled_directions.shape[2]

    def with_cameras(x):
        return x[:, :, None].expand(x.shape[:2] + (cameras,) + x.shape[2:])

    return (
        origins, directions, normals, with_cameras(w2o), with_cameras(encoding.object_style),
        with_cameras(encoding.object_deformation), with_cameras(encoding.object_in_scene),
    )


@torch.no_grad()
def render_frame_fast(
    scene: SceneConfig,
    composer,
    autoencoder,
    encoding,
    image_size: Tuple[int, int],
    patch_strides: Optional[Sequence[int]] = None,
    focal_length_multiplier: float = 1.0,
    step=0,
    mesh=None,
) -> torch.Tensor:
    """Full-frame eval render: camera rays, strided grids, render_rays_fast,
    then the multiresolution decode (or bilinear resize / raw features
    without an autoencoder). With a parallel.mesh.DeviceMesh `mesh` (the
    JAX function's ambient (data, rays) mesh), the rays render through
    render_rays_fast_sharded.

    :param composer: render.composer.SceneComposer.
    :param autoencoder: models.autoencoder.MultiresAutoencoder, or None.
    :param encoding: scene.encoding.SceneEncoding.
    :param step: bender PE annealing step; 0, as the JAX FrameRenderer uses.
    :return: (B, T, C, H, W, 3-or-F) frames clipped to [0, 1].
    """
    height, width = image_size
    inputs = frame_rays(encoding, image_size, patch_strides, focal_length_multiplier)
    if mesh is not None:
        results = render_rays_fast_sharded(mesh, scene, composer, *inputs, step=step)
    else:
        results = render_rays_fast(scene, composer, *inputs, step=step)
    features = results["coarse"]["global"]["integrated_features"]

    if autoencoder is not None and patch_strides:
        from playableenvironments_tpu_torch.models.autoencoder import (
            autoencoder_strides,
            features_count_by_layer,
        )

        strides = autoencoder_strides(scene.autoencoder)
        counts = features_count_by_layer(scene.autoencoder)
        grids, begin = [], 0
        for i, count in enumerate(counts):
            level = features[..., begin : begin + count]
            grids.append(sampling.split_strided_grid_samples(level, strides, image_size)[i])
            begin += count
        lead = grids[0].shape[:-3]
        decoded = autoencoder.decode([g.reshape((-1,) + g.shape[-3:]) for g in grids])
        frames = decoded.reshape(lead + decoded.shape[1:])
    elif patch_strides:
        folded = sampling.split_strided_grid_samples(features, list(patch_strides), image_size)[0]
        lead = folded.shape[:3]
        flat = folded.reshape((-1,) + folded.shape[3:]).permute(0, 3, 1, 2)
        resized = torch.nn.functional.interpolate(
            flat, size=(height, width), mode="bilinear", align_corners=False
        )
        frames = resized.permute(0, 2, 3, 1).reshape(lead + (height, width, folded.shape[-1]))
    else:
        frames = features.reshape(features.shape[:-2] + (height, width, features.shape[-1]))
    return torch.clamp(frames, 0.0, 1.0)
