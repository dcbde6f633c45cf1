"""Typed configuration for scenes, models, training, and evaluation.

Replaces the reference's YAML-with-importable-module-paths mechanism
(utils/configuration.py + `getattr(importlib.import_module(...), 'model')`
at e.g. train.py:34) with frozen dataclasses and a name registry: the same
degrees of freedom (per-object NeRF class, per-object encoders, pluggable
trainers/evaluators) with hashable, jit-static configs.

YAML files remain the user surface (`load_config(path)`); `from_dict` mirrors
the reference's schema (configs/tennis/193_...yaml) so its configs translate
mechanically.

The PyTorch port keeps this copy of `playableenvironments_tpu/config.py` so
that it imports nothing from the JAX package; the two must read a YAML file
the same way (tests/test_torch_port_core.py holds them equal).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

Range3 = Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]]


def _box(t) -> Range3:
    return tuple(tuple(float(v) for v in axis) for axis in t)  # type: ignore


@dataclass(frozen=True)
class PositionalEncoderConfig:
    """Sinusoidal PE settings (model/positional_encoder.py:9-27); num_steps
    enables coarse-to-fine annealing (annealable_positional_encoder.py:14-28)."""

    octaves: int = 10
    append_original: bool = True
    num_steps: Optional[int] = None  # annealing horizon; None = no annealing


@dataclass(frozen=True)
class RayBenderConfig:
    """Deformation field settings (model/nerf_models/positional_ray_bender_model.py:19-56)."""

    kind: str = "zeroed"  # "zeroed" | "positional"
    layers_width: int = 128
    layers_count: int = 6
    skip_layer_idx: int = 3
    position_encoder: PositionalEncoderConfig = field(
        default_factory=lambda: PositionalEncoderConfig(octaves=6, num_steps=60000)
    )
    # MLP matmul dtype (params and geometry stay float32; bfloat16 runs the
    # backbone on the MXU's fast path — model.compute_dtype in YAML).
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class NerfMLPConfig:
    """NeRF MLP settings (model/nerf_models/adain_style_nerf_model.py:19-55;
    skybox variant skybox_adain_style_nerf_model_v3.py:20-66)."""

    kind: str = "adain"  # "adain" | "skybox"
    layers_width: int = 256
    backbone_layers_count: int = 8
    output_features: int = 192
    skip_layer_idx: int = 4
    position_encoder: PositionalEncoderConfig = field(
        default_factory=PositionalEncoderConfig
    )
    # MLP matmul dtype (params, AdaIN statistics, and outputs stay float32;
    # bfloat16 runs the backbone on the MXU's fast path).
    compute_dtype: str = "float32"
    # Run the backbone + alpha head through the custom-VJP Pallas kernel
    # (activations stay in VMEM in both directions; bf16 matmuls, f32
    # accumulation). Interpreted (slow) off-TPU; the AdaIN head stays in XLA.
    use_fused_backbone: bool = False


@dataclass(frozen=True)
class ObjectModelConfig:
    """One object's radiance-field settings: bbox, sampling counts, sub-models.
    Mirrors a `model.object_models[i]` block (configs/tennis/193_...yaml)."""

    name: str = "object"
    bounding_box: Range3 = (( -1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0))
    positions_count_coarse: int = 32
    positions_count_fine: int = 32
    use_fine: bool = False
    empty_space_alpha: float = -3.5
    # Inference-path ray compaction (render.fast): evaluate the field MLP on
    # at most this fraction of rays (those whose rays hit the object's AABB,
    # compacted to a static-size buffer); missed rays take empty_space_alpha
    # directly. 1.0 disables. Small dynamic objects (players) typically
    # intersect <1% of frame rays, so 1/8 is lossless in practice; hits
    # beyond the budget fall back to empty space.
    ray_compaction: float = 1.0
    z_near_min: float = 5.0
    z_far_max: float = 70.0
    style_features: int = 64
    deformation_features: int = 32
    nerf: NerfMLPConfig = field(default_factory=NerfMLPConfig)
    bender: RayBenderConfig = field(default_factory=RayBenderConfig)


@dataclass(frozen=True)
class ParameterEncoderConfig:
    """Pose estimation per object model (model/static_object_parameters_encoder.py,
    classic_object_parameters_encoder.py, object_parameters_encoder_v4.py)."""

    kind: str = "static"  # "static" | "classic" | "learned_v4"
    objects_count: int = 1
    # Per-object ((x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi)) ranges.
    translation_range: Tuple[Range3, ...] = (((0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),)
    rotation_range: Tuple[Range3, ...] = (((0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),)
    # classic/learned_v4: index of the axis that is zero at the ground plane.
    zero_axis: int = 2
    # learned_v4: input crop size and feature width.
    input_size: Tuple[int, int] = (64, 64)
    rotation_axis: int = 2
    # learned_v4 (object_parameters_encoder_v4.py:292-313): box tightness
    # correction from box edge to object center.
    edge_to_center_distance: float = 0.0
    # Crop-box expansion (rows up, cols sideways; object_encoder_v4.py:61-78).
    expansion_rows: float = 0.0
    expansion_cols: float = 0.0
    # "bilinear" or "roi_pool" (reference-exact; object_parameters_encoder_v4.py:145).
    crop_mode: str = "bilinear"


@dataclass(frozen=True)
class ObjectEncoderConfig:
    """Style/deformation encoder per object model (model/object_encoder_v4.py /
    _v5.py)."""

    kind: str = "v4"  # "v4" (dynamic, camera-aware) | "v5" (background)
    input_size: Tuple[int, int] = (64, 64)
    style_features: int = 64
    deformation_features: int = 32
    # Crop-box expansion (rows up, cols sideways; object_encoder_v4.py:61-78).
    expansion_rows: float = 0.0
    expansion_cols: float = 0.0
    # "bilinear" (default: smooth, differentiable crop-resize) or "roi_pool"
    # (exact torchvision.ops.roi_pool semantics — required for bit-parity
    # with imported reference checkpoints, whose encoders trained on
    # quantized max-pooled crops; object_encoder_v4.py:130).
    crop_mode: str = "bilinear"


@dataclass(frozen=True)
class DynamicsNetworkConfig:
    """LSTM dynamics settings (model/dynamics_network_v9.py:24-61)."""

    output_features: int = 128
    layers_count: int = 1
    force_rotations_zero: bool = True
    force_z_translations_zero: bool = True
    rotation_axis: int = 2


@dataclass(frozen=True)
class ActionNetworkConfig:
    """Action-posterior MLP settings (model/action_network_v5.py:22-67)."""

    layers_width: int = 64
    layers_count: int = 3


@dataclass(frozen=True)
class AnimationModelConfig:
    """Per-dynamic-object action module (model/object_animation_model.py:21-84)."""

    name: str = "player"
    actions_count: int = 7
    action_space_dimension: int = 5
    hard_gumbel: bool = False
    gumbel_temperature: float = 1.0
    style_features: int = 64
    deformation_features: int = 32
    centroid_alpha: float = 0.1
    dynamics: DynamicsNetworkConfig = field(default_factory=DynamicsNetworkConfig)
    action_network: ActionNetworkConfig = field(default_factory=ActionNetworkConfig)


@dataclass(frozen=True)
class AutoencoderConfig:
    """Feature-renderer VAE settings (model/autoencoder_models/autoencoder_v7.py
    + encoder_v4/decoder_v6)."""

    variant: str = "v8"  # "v8" (EncoderV4+DecoderV6) | "v9" (EncoderV5+DecoderV7)
    input_features: int = 3
    bottleneck_features: int = 128
    bottleneck_blocks: int = 3
    # Downsampling factor per multiresolution level, e.g. (2, 1) means levels
    # at 1/4 and 1/8 resolution (cumulative powers of two).
    downsampling_layers_count: Tuple[int, ...] = (2, 1)
    variational: bool = True
    # Conv matmul dtype (params and BatchNorm statistics stay float32;
    # bfloat16 runs the convs on the MXU's fast path).
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class SceneConfig:
    """The full synthesis-model wiring: objects, encoders, autoencoder.

    Object ordering contract (model/utils/object_ids_helper.py:28-43): models
    for static objects come first; each model i contributes
    `parameter_encoders[i].objects_count` object instances.
    """

    object_models: Tuple[ObjectModelConfig, ...]
    parameter_encoders: Tuple[ParameterEncoderConfig, ...]
    object_encoders: Tuple[ObjectEncoderConfig, ...]
    static_object_models: int = 1
    apply_activation: bool = False
    fix_object_overlaps: bool = False
    use_weighted_sampling: bool = True
    sampling_weights: Tuple[float, ...] = ()
    autoencoder: Optional[AutoencoderConfig] = None
    animation_models: Tuple[AnimationModelConfig, ...] = ()
    # Independent fine-network instances for use_fine objects (the
    # reference ALWAYS builds separate coarse/fine modules,
    # object_composer.py:26-29); False shares the coarse parameters for the
    # fine pass — this repo's cheaper default. Only meaningful when some
    # object sets use_fine.
    separate_fine: bool = False

    def __post_init__(self):
        n = len(self.object_models)
        if len(self.parameter_encoders) != n or len(self.object_encoders) != n:
            raise ValueError(
                "object_models, parameter_encoders and object_encoders must "
                f"align: got {n}, {len(self.parameter_encoders)}, "
                f"{len(self.object_encoders)}"
            )
        if not 0 <= self.static_object_models <= n:
            raise ValueError("static_object_models out of range")


class ObjectIds:
    """Index arithmetic between objects, models, dynamic objects, and
    animation models. Static objects come first.
    Reference: model/utils/object_ids_helper.py:4-153.
    """

    def __init__(self, scene: SceneConfig):
        self.models_count = len(scene.object_models)
        self.static_models_count = scene.static_object_models
        self.dynamic_models_count = self.models_count - self.static_models_count

        self._model_by_object = []
        self._first_object_by_model = []
        for model_idx in range(self.models_count):
            self._first_object_by_model.append(len(self._model_by_object))
            count = scene.parameter_encoders[model_idx].objects_count
            self._model_by_object.extend([model_idx] * count)

        self.objects_count = len(self._model_by_object)
        self.static_objects_count = sum(
            1 for m in self._model_by_object if m < self.static_models_count
        )
        self.dynamic_objects_count = self.objects_count - self.static_objects_count

    def is_static_model(self, model_idx: int) -> bool:
        return model_idx < self.static_models_count

    def model_idx_by_object_idx(self, object_idx: int) -> int:
        return self._model_by_object[object_idx]

    def first_object_idx_by_model_idx(self, model_idx: int) -> int:
        return self._first_object_by_model[model_idx]

    def object_idx_by_dynamic_object_idx(self, dynamic_object_idx: int) -> int:
        object_idx = dynamic_object_idx + self.static_objects_count
        if object_idx >= self.objects_count:
            raise IndexError(f"dynamic object {dynamic_object_idx} out of range")
        return object_idx

    def dynamic_object_idx_by_object_idx(self, object_idx: int) -> int:
        dynamic_idx = object_idx - self.static_objects_count
        if dynamic_idx < 0:
            raise IndexError(f"object {object_idx} is not dynamic")
        return dynamic_idx

    def model_idx_by_dynamic_object_idx(self, dynamic_object_idx: int) -> int:
        return self.model_idx_by_object_idx(
            self.object_idx_by_dynamic_object_idx(dynamic_object_idx)
        )

    def animation_model_idx_by_dynamic_object_idx(self, dynamic_object_idx: int) -> int:
        return (
            self.model_idx_by_dynamic_object_idx(dynamic_object_idx)
            - self.static_models_count
        )


def animation_model_indexes(scene: SceneConfig) -> Tuple[int, ...]:
    """The animation model of each dynamic object.

    Where the scene has no more animation models than dynamic object
    models, one per dynamic object model, as ObjectIds maps them (dynamic
    objects of one model share it). A scene with more (configs/minecraft.yaml:
    two players of one object model, one animation model each) has one per
    dynamic object; the JAX package cannot build such a scene's playable
    model (it looks up an object model per animation model).
    """
    ids = ObjectIds(scene)
    count = len(scene.animation_models)
    if count <= ids.dynamic_models_count:
        return tuple(ids.animation_model_idx_by_dynamic_object_idx(d) for d in range(ids.dynamic_objects_count))
    if count != ids.dynamic_objects_count:
        raise ValueError(
            f"{count} animation models for {ids.dynamic_objects_count} dynamic objects of "
            f"{ids.dynamic_models_count} object models: one per object model or one per object"
        )
    return tuple(range(count))


def animation_object_models(scene: SceneConfig) -> Tuple[int, ...]:
    """The object model (its bounding box) that each animation model moves."""
    ids = ObjectIds(scene)
    models = {}
    for dynamic_idx, anim_idx in enumerate(animation_model_indexes(scene)):
        models.setdefault(anim_idx, ids.model_idx_by_dynamic_object_idx(dynamic_idx))
    return tuple(models.get(k, ids.static_models_count + k) for k in range(len(scene.animation_models)))


# ---------------------------------------------------------------------------
# Dict / YAML loading
# ---------------------------------------------------------------------------

_NERF_KIND_BY_ARCH = {
    "model.nerf_models.adain_style_nerf_model": "adain",
    "model.nerf_models.skybox_adain_style_nerf_model_v3": "skybox",
}
_BENDER_KIND_BY_ARCH = {
    "model.nerf_models.zeroed_ray_bender_model": "zeroed",
    "model.nerf_models.positional_ray_bender_model": "positional",
}
_PARAM_ENCODER_KIND_BY_ARCH = {
    "model.static_object_parameters_encoder": "static",
    "model.classic_object_parameters_encoder": "classic",
    "model.object_parameters_encoder_v4": "learned_v4",
}
_OBJECT_ENCODER_KIND_BY_ARCH = {
    "model.object_encoder_v4": "v4",
    "model.object_encoder_v5": "v5",
}


def _strip_name_key(block: Dict[str, Any]) -> Tuple[str, Dict[str, Any]]:
    """Reference YAML lists use '- name:' mapping items whose first key is the
    object's name with value None; recover (name, fields)."""
    name = "unnamed"
    named = False
    fields: Dict[str, Any] = {}
    for k, v in block.items():
        # Only the FIRST null-valued key is the name; later explicit nulls
        # (e.g. `num_steps: null`) are real field overrides, not names.
        if v is None and not named and not fields:
            name = k
            named = True
        else:
            fields[k] = v
    return name, fields


def _pe_from_dict(d: Dict[str, Any]) -> PositionalEncoderConfig:
    return PositionalEncoderConfig(
        octaves=int(d.get("octaves", 10)),
        append_original=bool(d.get("append_original", True)),
        num_steps=int(d["num_steps"]) if "num_steps" in d else None,
    )


def object_model_from_dict(
    block: Dict[str, Any], default_compute_dtype: str = "float32"
) -> ObjectModelConfig:
    name, d = _strip_name_key(block)
    nerf_d = d.get("nerf_model", {})
    bender_d = d.get("ray_bender_model", {})
    object_dtype = d.get("compute_dtype", default_compute_dtype)
    nerf = NerfMLPConfig(
        kind=_NERF_KIND_BY_ARCH.get(nerf_d.get("architecture", ""), "adain"),
        layers_width=int(nerf_d.get("layers_width", 256)),
        backbone_layers_count=int(nerf_d.get("backbone_layers_count", 8)),
        output_features=int(nerf_d.get("output_features", 192)),
        skip_layer_idx=int(nerf_d.get("skip_layer_idx", 4)),
        position_encoder=_pe_from_dict(nerf_d.get("position_encoder", {})),
        compute_dtype=str(nerf_d.get("compute_dtype", object_dtype)),
        use_fused_backbone=bool(nerf_d.get("use_fused_backbone", False)),
    )
    bender = RayBenderConfig(
        kind=_BENDER_KIND_BY_ARCH.get(bender_d.get("architecture", ""), "zeroed"),
        layers_width=int(bender_d.get("layers_width", 128)),
        layers_count=int(bender_d.get("layers_count", 6)),
        skip_layer_idx=int(bender_d.get("skip_layer_idx", 3)),
        position_encoder=_pe_from_dict(bender_d.get("position_encoder", {})),
        compute_dtype=str(bender_d.get("compute_dtype", object_dtype)),
    )
    return ObjectModelConfig(
        name=name,
        bounding_box=_box(d["bounding_box"]),
        positions_count_coarse=int(d.get("positions_count_coarse", 32)),
        positions_count_fine=int(d.get("positions_count_fine", 32)),
        use_fine=bool(d.get("use_fine", False)),
        empty_space_alpha=float(d.get("empty_space_alpha", -3.5)),
        ray_compaction=float(d.get("ray_compaction", 1.0)),
        z_near_min=float(d.get("z_near_min", 5.0)),
        z_far_max=float(d.get("z_far_max", 70.0)),
        style_features=int(d.get("style_features", 64)),
        deformation_features=int(d.get("deformation_features", 32)),
        nerf=nerf,
        bender=bender,
    )


def _expansion_from_dict(d: Dict[str, Any]) -> Tuple[float, float]:
    """(rows, cols) from the reference's `expansion_factor: {rows, cols}`
    block (or a scalar applied to both)."""
    e = d.get("expansion_factor", 0.0)
    if isinstance(e, dict):
        return float(e.get("rows", 0.0)), float(e.get("cols", 0.0))
    return float(e), float(e)


def parameter_encoder_from_dict(block: Dict[str, Any]) -> ParameterEncoderConfig:
    _, d = _strip_name_key(block)
    rows, cols = _expansion_from_dict(d)
    return ParameterEncoderConfig(
        kind=_PARAM_ENCODER_KIND_BY_ARCH.get(d.get("architecture", ""), "static"),
        objects_count=int(d.get("objects_count", 1)),
        translation_range=tuple(_box(r) for r in d.get("translation_range", [[(0, 0)] * 3])),
        rotation_range=tuple(_box(r) for r in d.get("rotation_range", [[(0, 0)] * 3])),
        zero_axis=int(d.get("zero_axis", 2)),
        input_size=tuple(d.get("input_size", (64, 64))),
        rotation_axis=int(d.get("rotation_axis", 2)),
        edge_to_center_distance=float(d.get("edge_to_center_distance", 0.0)),
        expansion_rows=rows,
        expansion_cols=cols,
    )


def object_encoder_from_dict(block: Dict[str, Any]) -> ObjectEncoderConfig:
    _, d = _strip_name_key(block)
    rows, cols = _expansion_from_dict(d)
    return ObjectEncoderConfig(
        kind=_OBJECT_ENCODER_KIND_BY_ARCH.get(d.get("architecture", ""), "v4"),
        input_size=tuple(d.get("input_size", (64, 64))),
        style_features=int(d.get("style_features", 64)),
        deformation_features=int(d.get("deformation_features", 32)),
        expansion_rows=rows,
        expansion_cols=cols,
    )


def animation_model_from_dict(block: Dict[str, Any]) -> AnimationModelConfig:
    name, d = _strip_name_key(block)
    dyn = d.get("dynamics_network", {})
    act = d.get("action_network", {})
    return AnimationModelConfig(
        name=name,
        actions_count=int(d.get("actions_count", 7)),
        action_space_dimension=int(d.get("action_space_dimension", 5)),
        hard_gumbel=bool(d.get("hard_gumbel", False)),
        gumbel_temperature=float(d.get("gumbel_temperature", 1.0)),
        style_features=int(d.get("style_features", 64)),
        deformation_features=int(d.get("deformation_features", 32)),
        centroid_alpha=float(d.get("centroid_estimator", {}).get("alpha", 0.1)),
        dynamics=DynamicsNetworkConfig(
            output_features=int(dyn.get("output_features", 128)),
            layers_count=int(dyn.get("layers_count", 1)),
            force_rotations_zero=bool(dyn.get("force_rotations_zero", True)),
            force_z_translations_zero=bool(dyn.get("force_z_translations_zero", True)),
            rotation_axis=int(dyn.get("rotation_axis", 2)),
        ),
        action_network=ActionNetworkConfig(
            layers_width=int(act.get("layers_width", 64)),
            layers_count=int(act.get("layers_count", 3)),
        ),
    )


def scene_from_dict(model_d: Dict[str, Any], playable_d: Optional[Dict[str, Any]] = None) -> SceneConfig:
    """Build a SceneConfig from the reference YAML's `model` (and optionally
    `playable_model`) sections."""
    ae = None
    if "autoencoder" in model_d:
        ae_d = model_d["autoencoder"]
        variant = "v9" if ae_d.get("architecture", "").endswith("v9") else "v8"
        ae = AutoencoderConfig(
            variant=variant,
            input_features=int(ae_d.get("input_features", 3)),
            bottleneck_features=int(ae_d.get("bottleneck_features", 128)),
            bottleneck_blocks=int(ae_d.get("bottleneck_blocks", 3)),
            downsampling_layers_count=tuple(ae_d.get("downsampling_layers_count", (2, 1))),
            compute_dtype=str(
                ae_d.get("compute_dtype", model_d.get("compute_dtype", "float32"))
            ),
        )
    animation = ()
    if playable_d is not None:
        animation = tuple(
            animation_model_from_dict(b)
            for b in playable_d.get("object_animation_models", [])
        )
    default_dtype = str(model_d.get("compute_dtype", "float32"))
    return SceneConfig(
        object_models=tuple(
            object_model_from_dict(b, default_dtype)
            for b in model_d["object_models"]
        ),
        parameter_encoders=tuple(
            parameter_encoder_from_dict(b) for b in model_d["object_parameters_encoder"]
        ),
        object_encoders=tuple(
            object_encoder_from_dict(b) for b in model_d["object_encoders"]
        ),
        static_object_models=int(model_d.get("static_object_models", 1)),
        apply_activation=bool(model_d.get("apply_activation", False)),
        fix_object_overlaps=bool(model_d.get("fix_object_overlaps", False)),
        use_weighted_sampling=bool(model_d.get("use_weighted_sampling", True)),
        sampling_weights=tuple(model_d.get("sampling_weights", ())),
        autoencoder=ae,
        animation_models=animation,
        # Reference-format configs with use_fine imply separate fine
        # instances (that is the only fine the reference has); an explicit
        # separate_fine key overrides.
        separate_fine=bool(
            model_d.get(
                "separate_fine",
                any(
                    b.get("use_fine", False)
                    for b in model_d["object_models"]
                ),
            )
        ),
    )


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config file into a plain dict."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def scene_from_yaml(path: str) -> SceneConfig:
    cfg = load_config(path)
    return scene_from_dict(cfg["model"], cfg.get("playable_model"))
