"""Import reference (PyTorch) checkpoints: their state_dicts into flax
variable trees.

A copy, in numpy alone, of playableenvironments_tpu/compat/torch_import.py
(the port imports nothing of the JAX package). The converters take a plain
{name: numpy array} mapping of a reference state_dict and give the flax
`params` / `batch_stats` trees of the JAX modules, the trees that
compat/from_flax.py loads strictly into the port's modules, so that one
bridge serves both the JAX package's checkpoints and the reference's. Layout
notes, as in the JAX module: a torch Linear (out, in) becomes a Dense kernel
(in, out), a Conv2d OIHW an HWIO kernel; the reference LSTMCell's two biases
are summed onto flax's hidden bias; the reference's masked batch norm keeps
a running std, stored as var = (std + eps)^2 - eps.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def _linear(state: Mapping[str, np.ndarray], prefix: str, bias: bool = True):
    out = {"kernel": np.ascontiguousarray(np.asarray(state[f"{prefix}.weight"]).T)}
    if bias:
        out["bias"] = np.asarray(state[f"{prefix}.bias"])
    return out


def convert_adain_nerf(
    state: Mapping[str, np.ndarray],
    prefix: str = "",
    backbone_layers_count: int = 8,
) -> Tuple[Dict, Dict]:
    """AdaInStyleNerfModel state_dict -> (params, batch_stats) for
    models.nerf.AdaInNerfMLP.

    Reference layout (adain_style_nerf_model.py:42-71):
      backbone_layers.{i}.{weight,bias}
      alpha_head.{weight,bias}
      features_head.0               Linear (no bias)        -> feat_0
      features_head.1               AffineTransformAdaIn    -> adain_0
      features_head.3               Linear (no bias)        -> feat_1
      features_head.4               AffineTransformAdaIn    -> adain_1
      features_head.6               Linear                  -> feat_out
    """
    p = prefix
    params: Dict = {}
    batch_stats: Dict = {}
    for i in range(backbone_layers_count):
        params[f"backbone_{i}"] = _linear(state, f"{p}backbone_layers.{i}")
    params["alpha_head"] = _linear(state, f"{p}alpha_head")

    head = f"{p}features_head"
    params["feat_0"] = _linear(state, f"{head}.0", bias=False)
    params["feat_1"] = _linear(state, f"{head}.3", bias=False)
    params["feat_out"] = _linear(state, f"{head}.6")
    for flax_name, torch_idx in (("adain_0", 1), ("adain_1", 4)):
        params[flax_name] = {
            "affine": _linear(state, f"{head}.{torch_idx}.affine_transform")
        }
        batch_stats[flax_name] = {
            "norm": {
                "mean": np.asarray(
                    state[f"{head}.{torch_idx}.ada_in.normalization.running_mean"]
                ),
                "var": np.asarray(
                    state[f"{head}.{torch_idx}.ada_in.normalization.running_var"]
                ),
            }
        }
    return params, batch_stats


def convert_positional_ray_bender(
    state: Mapping[str, np.ndarray],
    prefix: str = "",
    layers_count: int = 6,
) -> Dict:
    """PositionalRayBender state_dict -> params for models.nerf's bender.

    Reference layout (positional_ray_bender_model.py:40-79):
      backbone_layers.{i}.{weight,bias} -> backbone_{i}
      output_head.weight (no bias)      -> output_head (kernel only)
    """
    p = prefix
    params: Dict = {}
    for i in range(layers_count):
        params[f"backbone_{i}"] = _linear(state, f"{p}backbone_layers.{i}")
    params["output_head"] = _linear(state, f"{p}output_head", bias=False)
    return params


def split_state_dict(
    state: Mapping[str, np.ndarray], prefix: str
) -> Dict[str, np.ndarray]:
    """Sub-dict of keys under `prefix.` with the prefix stripped."""
    out = {}
    for key, value in state.items():
        if key.startswith(prefix + "."):
            out[key[len(prefix) + 1 :]] = value
    return out


# ---------------------------------------------------------------------------
# Convolutional modules (object encoders, autoencoder)
# ---------------------------------------------------------------------------


def _conv(state: Mapping[str, np.ndarray], prefix: str, bias: bool = False):
    """torch Conv2d (O, I, kH, kW) -> flax Conv kernel (kH, kW, I, O)."""
    out = {
        "kernel": np.ascontiguousarray(
            np.asarray(state[f"{prefix}.weight"]).transpose(2, 3, 1, 0)
        )
    }
    if bias:
        out["bias"] = np.asarray(state[f"{prefix}.bias"])
    return out


def _batchnorm(state: Mapping[str, np.ndarray], prefix: str):
    """torch BatchNorm2d -> (flax BatchNorm params, batch_stats)."""
    params = {
        "scale": np.asarray(state[f"{prefix}.weight"]),
        "bias": np.asarray(state[f"{prefix}.bias"]),
    }
    stats = {
        "mean": np.asarray(state[f"{prefix}.running_mean"]),
        "var": np.asarray(state[f"{prefix}.running_var"]),
    }
    return params, stats


def convert_residual_block(
    state: Mapping[str, np.ndarray], prefix: str
) -> Tuple[Dict, Dict]:
    """model/layers/residual_block.py ResidualBlock -> models.layers.ResidualBlock.

    Reference layout: conv1, bn1, conv2, bn2 [, downsample.0 (1x1 conv),
    downsample.2 (BN)]; ours: conv1, bn1, conv2, bn2 [, skip_conv, skip_bn].
    """
    p = prefix + "." if prefix else ""
    params: Dict = {"conv1": _conv(state, f"{p}conv1"), "conv2": _conv(state, f"{p}conv2")}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _batchnorm(state, f"{p}bn1")
    params["bn2"], stats["bn2"] = _batchnorm(state, f"{p}bn2")
    if f"{p}downsample.0.weight" in state:
        params["skip_conv"] = _conv(state, f"{p}downsample.0")
        params["skip_bn"], stats["skip_bn"] = _batchnorm(state, f"{p}downsample.2")
    return params, stats


def convert_object_encoder_v4(
    state: Mapping[str, np.ndarray], prefix: str = ""
) -> Tuple[Dict, Dict]:
    """ObjectEncoderV4 state_dict -> models.object_encoders.ObjectEncoderV4.

    Reference layout (object_encoder_v4.py:41-60): conv1, bn1,
    initial_backbone.0 (ResidualBlock emitting features+attention),
    final_backbone.0-3 (ResidualBlocks), style_head, deformation_head.
    """
    p = prefix
    params: Dict = {"conv1": _conv(state, f"{p}conv1")}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _batchnorm(state, f"{p}bn1")
    params["initial"], stats["initial"] = convert_residual_block(
        state, f"{p}initial_backbone.0"
    )
    for i in range(4):
        params[f"final_{i}"], stats[f"final_{i}"] = convert_residual_block(
            state, f"{p}final_backbone.{i}"
        )
    params["style_head"] = _linear(state, f"{p}style_head")
    params["deformation_head"] = _linear(state, f"{p}deformation_head")
    return params, stats


def convert_object_encoder_v5(
    state: Mapping[str, np.ndarray], prefix: str = ""
) -> Tuple[Dict, Dict]:
    """ObjectEncoderV5 state_dict -> models.object_encoders.ObjectEncoderV5.

    Reference layout (object_encoder_v5.py:41-62): conv1 (7x7 stride 2), bn1,
    initial_backbone.0-1, final_backbone.0-5, style_head, deformation_head.
    """
    p = prefix
    params: Dict = {"conv1": _conv(state, f"{p}conv1")}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _batchnorm(state, f"{p}bn1")
    for i in range(2):
        params[f"initial_{i}"], stats[f"initial_{i}"] = convert_residual_block(
            state, f"{p}initial_backbone.{i}"
        )
    for i in range(6):
        params[f"final_{i}"], stats[f"final_{i}"] = convert_residual_block(
            state, f"{p}final_backbone.{i}"
        )
    params["style_head"] = _linear(state, f"{p}style_head")
    params["deformation_head"] = _linear(state, f"{p}deformation_head")
    return params, stats


def convert_cyclegan_block(
    state: Mapping[str, np.ndarray], prefix: str
) -> Tuple[Dict, Dict]:
    """autoencoder_models/layers/cyclegan_resnet_block.py -> models.autoencoder.
    CycleGanResnetBlock. Reference Sequential indices with reflect padding:
    conv_block.{1,5} convs, conv_block.{2,6} norms;
    residual_connection_convolution.{0,1} when widths differ."""
    p = prefix + "." if prefix else ""
    params: Dict = {
        "conv1": _conv(state, f"{p}conv_block.1"),
        "conv2": _conv(state, f"{p}conv_block.5"),
    }
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _batchnorm(state, f"{p}conv_block.2")
    params["bn2"], stats["bn2"] = _batchnorm(state, f"{p}conv_block.6")
    if f"{p}residual_connection_convolution.0.weight" in state:
        params["skip_conv"] = _conv(state, f"{p}residual_connection_convolution.0")
        params["skip_bn"], stats["skip_bn"] = _batchnorm(
            state, f"{p}residual_connection_convolution.1"
        )
    return params, stats


def convert_multires_encoder(
    state: Mapping[str, np.ndarray],
    downsampling_layers_count=(2, 1),
    bottleneck_blocks: int = 3,
    prefix: str = "",
) -> Tuple[Dict, Dict]:
    """autoencoder_models/encoder_v4.py EncoderV4 -> MultiresEncoder (v8).

    Reference Sequential layout per set: [conv, norm, relu, avgpool] x downs
    then CycleGanResnetBlock x bottleneck_blocks, under
    downsampling_layers.{set}; initial_convolution.{1,2} = 7x7 conv + norm.
    """
    p = prefix
    params: Dict = {"initial_conv": _conv(state, f"{p}initial_convolution.1")}
    stats: Dict = {}
    params["initial_bn"], stats["initial_bn"] = _batchnorm(
        state, f"{p}initial_convolution.2"
    )
    for set_idx, downs in enumerate(downsampling_layers_count):
        seq = 0
        for i in range(downs):
            params[f"down_{set_idx}_{i}"] = _conv(
                state, f"{p}downsampling_layers.{set_idx}.{seq}"
            )
            (params[f"down_bn_{set_idx}_{i}"],
             stats[f"down_bn_{set_idx}_{i}"]) = _batchnorm(
                state, f"{p}downsampling_layers.{set_idx}.{seq + 1}"
            )
            seq += 4
        for b in range(bottleneck_blocks):
            (params[f"bottleneck_{set_idx}_{b}"],
             stats[f"bottleneck_{set_idx}_{b}"]) = convert_cyclegan_block(
                state, f"{p}downsampling_layers.{set_idx}.{seq + b}"
            )
    return params, stats


def convert_multires_decoder(
    state: Mapping[str, np.ndarray],
    downsampling_layers_count=(2, 1),
    bottleneck_blocks: int = 3,
    prefix: str = "",
) -> Tuple[Dict, Dict]:
    """autoencoder_models/decoder_v6.py DecoderV6 -> MultiresDecoder (v8).

    Reference Sequential layout per upsample_blocks.{set}: CycleGanResnetBlock
    x bottleneck_blocks then [upsample, conv, norm, relu] x downs (conv at
    B + 4i + 1); final_convolutions.1 = 7x7 conv (with bias).
    """
    p = prefix
    params: Dict = {}
    stats: Dict = {}
    reversed_counts = list(reversed(downsampling_layers_count))
    for set_idx, downs in enumerate(reversed_counts):
        for b in range(bottleneck_blocks):
            (params[f"bottleneck_{set_idx}_{b}"],
             stats[f"bottleneck_{set_idx}_{b}"]) = convert_cyclegan_block(
                state, f"{p}upsample_blocks.{set_idx}.{b}"
            )
        for i in range(downs):
            base = bottleneck_blocks + 4 * i
            params[f"up_{set_idx}_{i}"] = _conv(
                state, f"{p}upsample_blocks.{set_idx}.{base + 1}"
            )
            (params[f"up_bn_{set_idx}_{i}"],
             stats[f"up_bn_{set_idx}_{i}"]) = _batchnorm(
                state, f"{p}upsample_blocks.{set_idx}.{base + 2}"
            )
    params["final_conv"] = _conv(state, f"{p}final_convolutions.1", bias=True)
    return params, stats


def convert_skybox_nerf(
    state: Mapping[str, np.ndarray],
    prefix: str = "",
    backbone_layers_count: int = 8,
) -> Tuple[Dict, Dict]:
    """SkyboxAdaInStyleNerfModelV3 state_dict -> models.nerf.SkyboxNerfMLP:
    the AdaIn layout (skybox_adain_style_nerf_model_v3.py:45-64) without the
    alpha head (alpha is forced fully opaque)."""
    p = prefix
    params: Dict = {}
    batch_stats: Dict = {}
    for i in range(backbone_layers_count):
        params[f"backbone_{i}"] = _linear(state, f"{p}backbone_layers.{i}")
    head = f"{p}features_head"
    params["feat_0"] = _linear(state, f"{head}.0", bias=False)
    params["feat_1"] = _linear(state, f"{head}.3", bias=False)
    params["feat_out"] = _linear(state, f"{head}.6")
    for flax_name, torch_idx in (("adain_0", 1), ("adain_1", 4)):
        params[flax_name] = {
            "affine": _linear(state, f"{head}.{torch_idx}.affine_transform")
        }
        batch_stats[flax_name] = {
            "norm": {
                "mean": np.asarray(
                    state[f"{head}.{torch_idx}.ada_in.normalization.running_mean"]
                ),
                "var": np.asarray(
                    state[f"{head}.{torch_idx}.ada_in.normalization.running_var"]
                ),
            }
        }
    return params, batch_stats


def convert_object_parameters_encoder_v4(
    state: Mapping[str, np.ndarray], prefix: str = ""
) -> Tuple[Dict, Dict]:
    """ObjectParametersEncoderV4 state_dict ->
    models.parameter_encoders.ObjectParametersEncoderV4 (same CNN widths by
    construction; object_parameters_encoder_v4.py:47-66)."""
    p = prefix
    params: Dict = {"conv1": _conv(state, f"{p}conv1")}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _batchnorm(state, f"{p}bn1")
    for i in range(2):
        params[f"initial_{i}"], stats[f"initial_{i}"] = convert_residual_block(
            state, f"{p}initial_backbone.{i}"
        )
    for i in range(6):
        params[f"final_{i}"], stats[f"final_{i}"] = convert_residual_block(
            state, f"{p}final_backbone.{i}"
        )
    params["rotation_head"] = _linear(state, f"{p}rotation_head")
    return params, stats


def convert_camera_offsets(
    state: Mapping[str, np.ndarray],
    memory_size: int,
    cameras_count: int,
    prefix: str = "camera_parameters_offsets.",
) -> Dict:
    """CameraParametersStorage (IndexedStorage nn.ParameterList; one (7,) row
    per (camera, frame), camera-major: row = camera * memory + frame,
    camera_parameters_storage.py:44-47) -> our dense (memory, cameras, 7)
    table."""
    rows = [
        np.asarray(state[f"{prefix}storage.storage.{j}"])
        for j in range(memory_size * cameras_count)
    ]
    table = np.stack(rows).reshape(cameras_count, memory_size, 7)
    return {"storage": np.ascontiguousarray(table.transpose(1, 0, 2))}


def convert_object_composer(
    state: Mapping[str, np.ndarray],
    scene,
    prefix: str = "object_composer.",
    separate_fine: bool = False,
) -> Tuple[Dict, Dict]:
    """ObjectComposer subtree of a reference state_dict -> (params, stats)
    for render.composer.SceneComposer, keyed object_model_{i}.

    Reference layout (object_composer.py:26-29): one coarse module per object
    model at object_models_coarse.{i} with nerf_model + ray_bender children,
    plus a SEPARATE fine instance at object_models_fine.{i} for objects with
    use_fine. Published configs all run use_fine=False; pass
    separate_fine=True to also map the fine instances onto
    SceneComposer(separate_fine=True)'s object_model_fine_{i} entries
    (without it, use_fine objects reuse the coarse parameters for the fine
    pass — the importer then only maps coarse weights).
    """
    params: Dict = {}
    stats: Dict = {}

    def convert_instance(om, p):
        entry_p: Dict = {}
        entry_s: Dict = {}
        if om.nerf.kind == "skybox":
            entry_p["nerf"], entry_s["nerf"] = convert_skybox_nerf(
                state, p + "nerf_model.", om.nerf.backbone_layers_count
            )
        else:
            entry_p["nerf"], entry_s["nerf"] = convert_adain_nerf(
                state, p + "nerf_model.", om.nerf.backbone_layers_count
            )
        if om.bender.kind == "positional":
            entry_p["ray_bender"] = convert_positional_ray_bender(
                state, p + "ray_bender.", om.bender.layers_count
            )
        return entry_p, entry_s

    for i, om in enumerate(scene.object_models):
        entry_p, entry_s = convert_instance(
            om, f"{prefix}object_models_coarse.{i}."
        )
        params[f"object_model_{i}"] = entry_p
        stats[f"object_model_{i}"] = entry_s
        if separate_fine and om.use_fine:
            fine_p, fine_s = convert_instance(
                om, f"{prefix}object_models_fine.{i}."
            )
            params[f"object_model_fine_{i}"] = fine_p
            stats[f"object_model_fine_{i}"] = fine_s
    return params, stats


def convert_environment_model(
    state: Mapping[str, np.ndarray], scene, cameras_count: int = 1
) -> Tuple[Dict, Dict]:
    """Full phase-2 EnvironmentModel state_dict -> (params, batch_stats) for
    render.environment_model.EnvironmentModel.

    Reference submodule prefixes (environment_model.py:39-59 +
    environment_model_backpropagated_autoencoder.py:31):
      object_composer.object_models_coarse.{i}.{nerf_model,ray_bender}
      object_parameters_encoders.{i}   object_encoders.{i}
      camera_parameters_offsets        autoencoder_model.{encoder,decoder}

    :param scene: config.SceneConfig describing the checkpoint's architecture.
    :return: (params, batch_stats) trees matching EnvironmentModel.init's.
    """
    composer_p, composer_s = convert_object_composer(
        state, scene, separate_fine=scene.separate_fine
    )
    params: Dict = {"composer": composer_p}
    stats: Dict = {"composer": composer_s}

    for i, oe in enumerate(scene.object_encoders):
        convert = (
            convert_object_encoder_v4 if oe.kind == "v4" else convert_object_encoder_v5
        )
        (params[f"object_encoder_{i}"], stats[f"object_encoder_{i}"]) = convert(
            state, f"object_encoders.{i}."
        )

    for i, pe in enumerate(scene.parameter_encoders):
        if pe.kind == "learned_v4":
            (params[f"parameters_encoder_{i}"],
             stats[f"parameters_encoder_{i}"]) = convert_object_parameters_encoder_v4(
                state, f"object_parameters_encoders.{i}."
            )

    row_keys = [
        k for k in state
        if k.startswith("camera_parameters_offsets.storage.storage.")
    ]
    if row_keys:
        if len(row_keys) % cameras_count:
            raise ValueError(
                f"checkpoint has {len(row_keys)} camera-offset rows, not "
                f"divisible by cameras_count={cameras_count}; the checkpoint "
                "was trained with a different camera set — pass the matching "
                "cameras_count (reference allowed_cameras at train time)"
            )
        memory_size = len(row_keys) // cameras_count
        missing = [
            j for j in range(len(row_keys))
            if f"camera_parameters_offsets.storage.storage.{j}" not in state
        ]
        if missing:
            raise ValueError(
                f"camera-offset rows are not contiguous 0..{len(row_keys) - 1}: "
                f"missing indices {missing[:5]}..."
            )
        params["camera_offsets"] = convert_camera_offsets(
            state, memory_size, cameras_count
        )

    if scene.autoencoder is not None and any(
        k.startswith("autoencoder_model.") for k in state
    ):
        ds = tuple(scene.autoencoder.downsampling_layers_count)
        bb = scene.autoencoder.bottleneck_blocks
        enc_p, enc_s = convert_multires_encoder(
            state, ds, bb, prefix="autoencoder_model.encoder."
        )
        dec_p, dec_s = convert_multires_decoder(
            state, ds, bb, prefix="autoencoder_model.decoder."
        )
        params["autoencoder"] = {"encoder": enc_p, "decoder": dec_p}
        stats["autoencoder"] = {"encoder": enc_s, "decoder": dec_s}

    return params, stats


# ---------------------------------------------------------------------------
# Phase-3 (playable / action) modules
# ---------------------------------------------------------------------------


def convert_lstm_cell(
    state: Mapping[str, np.ndarray], prefix: str
) -> Dict[str, Dict[str, np.ndarray]]:
    """torch nn.LSTMCell -> flax nn.OptimizedLSTMCell params.

    torch packs gates row-wise in (i, f, g, o) order into weight_ih (4H, In) /
    weight_hh (4H, H) with two bias vectors; flax keeps per-gate Dense modules
    ii/if/ig/io (input, no bias) and hi/hf/hg/ho (hidden, bias). Gate
    activations agree (sigmoid i/f/o, tanh g), so the mapping is a slice +
    transpose, with the two torch biases summed onto the hidden side.
    """
    p = prefix + "." if prefix else ""
    w_ih = np.asarray(state[f"{p}weight_ih"])
    w_hh = np.asarray(state[f"{p}weight_hh"])
    b = np.asarray(state[f"{p}bias_ih"]) + np.asarray(state[f"{p}bias_hh"])
    hidden = w_hh.shape[1]
    params: Dict = {}
    for gate_idx, gate in enumerate("ifgo"):
        sl = slice(gate_idx * hidden, (gate_idx + 1) * hidden)
        params[f"i{gate}"] = {"kernel": np.ascontiguousarray(w_ih[sl].T)}
        params[f"h{gate}"] = {
            "kernel": np.ascontiguousarray(w_hh[sl].T),
            "bias": np.ascontiguousarray(b[sl]),
        }
    return params


def convert_dynamics_network(
    state: Mapping[str, np.ndarray], prefix: str = "", cells_count: int = 1
) -> Dict:
    """DynamicsNetworkV9/V4 state_dict -> models.dynamics.DynamicsNetwork.

    Reference layout (dynamics_network_v9.py:48-74): all_cells.{i} LSTMCells,
    all_initial_hidden_[cell_]states.{i}, mlp_backbone.0 Linear, mlp_heads
    [rotation(6), translation(3), style, deformation].
    """
    p = prefix
    params: Dict = {}
    for i in range(cells_count):
        params[f"lstm_{i}"] = convert_lstm_cell(state, f"{p}all_cells.{i}")
        params[f"initial_hidden_{i}"] = np.asarray(
            state[f"{p}all_initial_hidden_states.{i}"]
        ).reshape(-1)
        params[f"initial_cell_{i}"] = np.asarray(
            state[f"{p}all_initial_hidden_cell_states.{i}"]
        ).reshape(-1)
    params["backbone"] = _linear(state, f"{p}mlp_backbone.0")
    for head_idx, head in enumerate(
        ("rotation_head", "translation_head", "style_head", "deformation_head")
    ):
        params[head] = _linear(state, f"{p}mlp_heads.{head_idx}")
    return params


def convert_action_network(
    state: Mapping[str, np.ndarray], prefix: str = "", layers_count: int = 3
) -> Tuple[Dict, Dict]:
    """ActionNetworkV5 state_dict -> models.action.ActionNetwork.

    Reference layout (action_network_v5.py:51-65): mlp_backbone =
    MaskedSequential of [Linear, MaskedBatchNorm1d, ReLU] x layers (indices
    3k / 3k+1), then mean_fc / log_variance_fc / final_fc. The reference
    tracks a running STD; our MaskedBatchNorm stores variance (std^2).
    """
    p = prefix
    params: Dict = {}
    stats: Dict = {}
    for i in range(layers_count):
        params[f"mlp_{i}"] = _linear(state, f"{p}mlp_backbone.{3 * i}")
        bn = f"{p}mlp_backbone.{3 * i + 1}"
        params[f"bn_{i}"] = {
            "scale": np.asarray(state[f"{bn}.gamma"]),
            "bias": np.asarray(state[f"{bn}.beta"]),
        }
        std = np.asarray(state[f"{bn}.running_std"])
        # The reference normalizes by (std + eps) (masked_batch_norm.py eval
        # path) while MaskedBatchNorm divides by sqrt(var + eps); storing
        # var = (std + eps)^2 - eps makes both normalizations identical even
        # for low-variance features.
        eps = 1e-5  # MaskedBatchNorm.epsilon default, matching the reference
        stats[f"bn_{i}"] = {
            "mean": np.asarray(state[f"{bn}.running_mean"]),
            "var": (std + eps) ** 2 - eps,
        }
    params["mean_fc"] = _linear(state, f"{p}mean_fc")
    params["log_variance_fc"] = _linear(state, f"{p}log_variance_fc")
    params["final_fc"] = _linear(state, f"{p}final_fc")
    return params, stats


def convert_animation_model(
    state: Mapping[str, np.ndarray],
    prefix: str = "",
    cells_count: int = 1,
    action_layers_count: int = 3,
) -> Tuple[Dict, Dict, np.ndarray]:
    """ObjectAnimationModel state_dict -> (params, batch_stats, centroids) for
    models.action.ObjectAnimationModel (+ the EMA centroids that live in the
    trainer's extra state here, centroid_estimator.py:28)."""
    p = prefix
    action_p, action_s = convert_action_network(
        state, f"{p}action_network.", action_layers_count
    )
    params = {
        "action_network": action_p,
        "dynamics_network": convert_dynamics_network(
            state, f"{p}dynamics_network.", cells_count
        ),
    }
    stats = {"action_network": action_s}
    centroids = np.asarray(state[f"{p}centroid_estimator.estimated_centroids"])
    return params, stats, centroids


def convert_playable_model(
    state: Mapping[str, np.ndarray], animation_configs
) -> Tuple[Dict, Dict, list]:
    """Phase-3 PlayableEnvironmentModel state_dict -> (params, batch_stats,
    per-object centroids) for render.playable_model.PlayableEnvironmentModel.

    Reference layout (playable_environment_model.py:28-31): the frozen
    environment model under `environment_model.` (convert separately with
    convert_environment_model on the phase-2 config) and
    `object_animation_models.{i}.` per dynamic object.
    """
    params: Dict = {}
    stats: Dict = {}
    centroids = []
    for i, cfg in enumerate(animation_configs):
        cells = getattr(getattr(cfg, "dynamics", None), "layers_count", 1)
        layers = getattr(getattr(cfg, "action_network", None), "layers_count", 3)
        p, s, c = convert_animation_model(
            state, f"object_animation_models.{i}.", cells, layers
        )
        params[f"animation_model_{i}"] = p
        stats[f"animation_model_{i}"] = s
        centroids.append(c)
    return params, stats, centroids
