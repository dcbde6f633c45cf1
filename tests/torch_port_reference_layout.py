"""Reference-layout state dicts from flax variable trees: the inverse of
compat/torch_import.py's converters, for tests and chip_smoke.py.

The reference (PyTorch) implementation saves its models as state_dicts in
its own layout; the import CLI converts them into flax trees
(compat/torch_import.py) and loads those into the port. To test that path
without the reference's code or trained weights, these functions write a
flax tree (the JAX modules' params / batch_stats, nested dicts of numpy
arrays) back into the reference's layout:

- a Dense kernel (in, out) becomes a Linear weight (out, in), an HWIO Conv
  kernel an OIHW Conv2d weight, BatchNorm scale/bias/mean/var become
  weight/bias/running_mean/running_var;
- an LSTM cell's per-gate Dense modules are packed row-wise in (i, f, g, o)
  order into weight_ih / weight_hh, and the flax hidden bias is split into
  two equal halves bias_ih and bias_hh (their sum is the bias exactly);
- the action network's masked batch norm stores a running std whose
  (std + eps)^2 - eps gives back the variance exactly in float32 (found by
  a search around sqrt(var + eps) - eps; `std_variance` makes variances
  that have one);
- the camera-offset table (memory, cameras, 7) becomes one (7,) row a
  (camera, frame), camera-major.

JAX's converters take the output back to the same tree bit for bit
(tests/test_torch_port_import.py pins it). Nothing here imports JAX or
torch; `torch_checkpoint` needs torch only to write the file.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

EPS = 1e-5  # the masked batch norm's epsilon, as compat/torch_import.py


def flax_variables(state_dict: Mapping, skip: Sequence[str] = ()) -> Dict[str, Dict]:
    """A port module's state_dict ({name: tensor or array}) as the flax
    variables it loads from (the inverse of compat/from_flax.py's renames):
    2-D/3-D/4-D `weight`s as Dense (in, out), Conv1d (k, in, out) and HWIO
    kernels, 1-D ones as norm scales, `running_mean`/`mean` and
    `running_var`/`var` in batch_stats, every other leaf under its own name
    in params. Keys starting with one of `skip` are left out."""
    params: Dict = {}
    stats: Dict = {}
    for key, value in state_dict.items():
        if key.startswith(tuple(skip)):
            continue
        *path, leaf = key.split(".")
        value = np.asarray(value.detach().cpu().numpy() if hasattr(value, "detach") else value, np.float32)
        if leaf == "weight" and value.ndim >= 2:
            leaf = "kernel"
            value = {2: lambda x: x.T, 3: lambda x: x.transpose(2, 1, 0),
                     4: lambda x: x.transpose(2, 3, 1, 0)}[value.ndim](value)
        elif leaf == "weight":
            leaf = "scale"
        elif leaf in ("running_mean", "running_var"):
            leaf = leaf[len("running_"):]
        node = stats if leaf in ("mean", "var") else params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(value)
    return {"params": params, "batch_stats": stats}


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32))


def _linear(out: Dict, tree: Mapping, prefix: str):
    out[f"{prefix}.weight"] = _f32(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _f32(tree["bias"])


def _conv(out: Dict, tree: Mapping, prefix: str):
    out[f"{prefix}.weight"] = _f32(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in tree:
        out[f"{prefix}.bias"] = _f32(tree["bias"])


def _batchnorm(out: Dict, params: Mapping, stats: Mapping, prefix: str):
    out[f"{prefix}.weight"] = _f32(params["scale"])
    out[f"{prefix}.bias"] = _f32(params["bias"])
    out[f"{prefix}.running_mean"] = _f32(stats["mean"])
    out[f"{prefix}.running_var"] = _f32(stats["var"])


def _check_keys(tree: Mapping, known, label: str):
    unknown = set(tree) - set(known)
    if unknown:
        raise KeyError(f"{label}: no reference layout for {sorted(unknown)}")


def adain_nerf(out: Dict, params: Mapping, stats: Mapping, prefix: str, with_alpha: bool = True):
    layers = sorted(k for k in params if k.startswith("backbone_"))
    for name in layers:
        _linear(out, params[name], f"{prefix}backbone_layers.{name.split('_')[1]}")
    if with_alpha:
        _linear(out, params["alpha_head"], f"{prefix}alpha_head")
    head = f"{prefix}features_head"
    _linear(out, params["feat_0"], f"{head}.0")
    _linear(out, params["feat_1"], f"{head}.3")
    _linear(out, params["feat_out"], f"{head}.6")
    for name, index in (("adain_0", 1), ("adain_1", 4)):
        _linear(out, params[name]["affine"], f"{head}.{index}.affine_transform")
        out[f"{head}.{index}.ada_in.normalization.running_mean"] = _f32(stats[name]["norm"]["mean"])
        out[f"{head}.{index}.ada_in.normalization.running_var"] = _f32(stats[name]["norm"]["var"])
    _check_keys(params, layers + ["alpha_head", "feat_0", "feat_1", "feat_out", "adain_0", "adain_1"], prefix)


def positional_bender(out: Dict, params: Mapping, prefix: str):
    layers = sorted(k for k in params if k.startswith("backbone_"))
    for name in layers:
        _linear(out, params[name], f"{prefix}backbone_layers.{name.split('_')[1]}")
    _linear(out, params["output_head"], f"{prefix}output_head")
    _check_keys(params, layers + ["output_head"], prefix)


def residual_block(out: Dict, params: Mapping, stats: Mapping, prefix: str):
    _conv(out, params["conv1"], f"{prefix}.conv1")
    _conv(out, params["conv2"], f"{prefix}.conv2")
    _batchnorm(out, params["bn1"], stats["bn1"], f"{prefix}.bn1")
    _batchnorm(out, params["bn2"], stats["bn2"], f"{prefix}.bn2")
    if "skip_conv" in params:
        _conv(out, params["skip_conv"], f"{prefix}.downsample.0")
        _batchnorm(out, params["skip_bn"], stats["skip_bn"], f"{prefix}.downsample.2")
    _check_keys(params, ("conv1", "conv2", "bn1", "bn2", "skip_conv", "skip_bn"), prefix)


def _encoder_cnn(out: Dict, params: Mapping, stats: Mapping, prefix: str, heads: Sequence[str]):
    """ObjectEncoderV4/V5 and ObjectParametersEncoderV4: conv1, bn1,
    initial (V4's one block) or initial_i, final_i, then linear heads."""
    _conv(out, params["conv1"], f"{prefix}conv1")
    _batchnorm(out, params["bn1"], stats["bn1"], f"{prefix}bn1")
    known = ["conv1", "bn1", *heads]
    for name in params:
        if name == "initial":
            residual_block(out, params[name], stats[name], f"{prefix}initial_backbone.0")
        elif name.startswith(("initial_", "final_")):
            group, index = name.split("_")
            residual_block(out, params[name], stats[name], f"{prefix}{group}_backbone.{index}")
        else:
            continue
        known.append(name)
    for head in heads:
        _linear(out, params[head], f"{prefix}{head}")
    _check_keys(params, known, prefix)


def cyclegan_block(out: Dict, params: Mapping, stats: Mapping, prefix: str):
    _conv(out, params["conv1"], f"{prefix}.conv_block.1")
    _conv(out, params["conv2"], f"{prefix}.conv_block.5")
    _batchnorm(out, params["bn1"], stats["bn1"], f"{prefix}.conv_block.2")
    _batchnorm(out, params["bn2"], stats["bn2"], f"{prefix}.conv_block.6")
    if "skip_conv" in params:
        _conv(out, params["skip_conv"], f"{prefix}.residual_connection_convolution.0")
        _batchnorm(out, params["skip_bn"], stats["skip_bn"], f"{prefix}.residual_connection_convolution.1")
    _check_keys(params, ("conv1", "conv2", "bn1", "bn2", "skip_conv", "skip_bn"), prefix)


def multires_encoder(out: Dict, params: Mapping, stats: Mapping, downsampling_layers_count, bottleneck_blocks: int,
                     prefix: str):
    _conv(out, params["initial_conv"], f"{prefix}initial_convolution.1")
    _batchnorm(out, params["initial_bn"], stats["initial_bn"], f"{prefix}initial_convolution.2")
    known = ["initial_conv", "initial_bn"]
    for s, downs in enumerate(downsampling_layers_count):
        for i in range(downs):
            _conv(out, params[f"down_{s}_{i}"], f"{prefix}downsampling_layers.{s}.{4 * i}")
            _batchnorm(out, params[f"down_bn_{s}_{i}"], stats[f"down_bn_{s}_{i}"],
                       f"{prefix}downsampling_layers.{s}.{4 * i + 1}")
            known += [f"down_{s}_{i}", f"down_bn_{s}_{i}"]
        for b in range(bottleneck_blocks):
            name = f"bottleneck_{s}_{b}"
            cyclegan_block(out, params[name], stats[name], f"{prefix}downsampling_layers.{s}.{4 * downs + b}")
            known.append(name)
    _check_keys(params, known, prefix)


def multires_decoder(out: Dict, params: Mapping, stats: Mapping, downsampling_layers_count, bottleneck_blocks: int,
                     prefix: str):
    known = ["final_conv"]
    for s, downs in enumerate(reversed(list(downsampling_layers_count))):
        for b in range(bottleneck_blocks):
            name = f"bottleneck_{s}_{b}"
            cyclegan_block(out, params[name], stats[name], f"{prefix}upsample_blocks.{s}.{b}")
            known.append(name)
        for i in range(downs):
            base = bottleneck_blocks + 4 * i
            _conv(out, params[f"up_{s}_{i}"], f"{prefix}upsample_blocks.{s}.{base + 1}")
            _batchnorm(out, params[f"up_bn_{s}_{i}"], stats[f"up_bn_{s}_{i}"],
                       f"{prefix}upsample_blocks.{s}.{base + 2}")
            known += [f"up_{s}_{i}", f"up_bn_{s}_{i}"]
    _conv(out, params["final_conv"], f"{prefix}final_convolutions.1")
    _check_keys(params, known, prefix)


def camera_offsets(out: Dict, params: Mapping, prefix: str = "camera_parameters_offsets."):
    table = np.asarray(params["storage"], np.float32)  # (memory, cameras, 7)
    rows = table.transpose(1, 0, 2).reshape(-1, table.shape[-1])
    for j, row in enumerate(rows):
        out[f"{prefix}storage.storage.{j}"] = _f32(row)


def environment_state_dict(variables: Mapping, scene) -> Dict[str, np.ndarray]:
    """A phase-2 EnvironmentModel's flax variables ({"params",
    "batch_stats"}) in the reference's state_dict layout; `scene` is the
    config.SceneConfig they were made for (the JAX package's or the
    port's)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    composer_p, composer_s = params["composer"], stats.get("composer", {})
    for i, om in enumerate(scene.object_models):
        for kind, coarse_or_fine in (("", "coarse"), ("fine_", "fine")):
            name = f"object_model_{kind}{i}"
            if name not in composer_p:
                continue
            prefix = f"object_composer.object_models_{coarse_or_fine}.{i}."
            entry_p, entry_s = composer_p[name], composer_s.get(name, {})
            adain_nerf(out, entry_p["nerf"], entry_s["nerf"], prefix + "nerf_model.",
                       with_alpha=om.nerf.kind != "skybox")
            if "ray_bender" in entry_p:
                positional_bender(out, entry_p["ray_bender"], prefix + "ray_bender.")
    for i, oe in enumerate(scene.object_encoders):
        _encoder_cnn(out, params[f"object_encoder_{i}"], stats[f"object_encoder_{i}"], f"object_encoders.{i}.",
                     ("style_head", "deformation_head"))
    for i, pe in enumerate(scene.parameter_encoders):
        if pe.kind == "learned_v4":
            _encoder_cnn(out, params[f"parameters_encoder_{i}"], stats[f"parameters_encoder_{i}"],
                         f"object_parameters_encoders.{i}.", ("rotation_head",))
    if "camera_offsets" in params:
        camera_offsets(out, params["camera_offsets"])
    if "autoencoder" in params:
        ae = scene.autoencoder
        ds, bb = tuple(ae.downsampling_layers_count), ae.bottleneck_blocks
        multires_encoder(out, params["autoencoder"]["encoder"], stats["autoencoder"]["encoder"], ds, bb,
                         "autoencoder_model.encoder.")
        multires_decoder(out, params["autoencoder"]["decoder"], stats["autoencoder"]["decoder"], ds, bb,
                         "autoencoder_model.decoder.")
    known = {"composer", "camera_offsets", "autoencoder"} | {n for n in params if n.startswith(
        ("object_encoder_", "parameters_encoder_"))}
    _check_keys(params, known, "environment model")
    return out


def std_variance(std: np.ndarray) -> np.ndarray:
    """The variance the converter makes of a running std: (std + eps)^2 -
    eps in float32, a value `running_std` can take back exactly."""
    return _f32((_f32(std) + EPS) ** 2 - EPS)


def running_std(var: np.ndarray, exact: bool = True) -> np.ndarray:
    """A float32 std whose (std + eps)^2 - eps is `var` exactly; raises
    where no float32 std nearby has it, unless `exact` is False (then the
    nearest, sqrt(var + eps) - eps rounded)."""
    var = _f32(var)
    guess = _f32(np.sqrt(var.astype(np.float64) + EPS) - EPS)
    out = guess.copy()
    found = std_variance(guess) == var
    for offset in range(1, 9):
        for direction in (np.inf, -np.inf):
            candidate = guess
            for _ in range(offset):
                candidate = np.nextafter(candidate, np.float32(direction)).astype(np.float32)
            hit = ~found & (std_variance(candidate) == var)
            out[hit] = candidate[hit]
            found |= hit
    if exact and not found.all():
        raise ValueError(f"{int((~found).sum())} variances have no float32 running std (make them with std_variance)")
    return out


def lstm_cell(out: Dict, params: Mapping, prefix: str):
    w_ih = np.concatenate([np.asarray(params[f"i{g}"]["kernel"]).T for g in "ifgo"], axis=0)
    w_hh = np.concatenate([np.asarray(params[f"h{g}"]["kernel"]).T for g in "ifgo"], axis=0)
    bias = np.concatenate([np.asarray(params[f"h{g}"]["bias"], np.float32) for g in "ifgo"])
    out[f"{prefix}.weight_ih"] = _f32(w_ih)
    out[f"{prefix}.weight_hh"] = _f32(w_hh)
    out[f"{prefix}.bias_ih"] = _f32(bias / 2)
    out[f"{prefix}.bias_hh"] = _f32(bias / 2)
    _check_keys(params, [f"{d}{g}" for d in "ih" for g in "ifgo"], prefix)


def dynamics_network(out: Dict, params: Mapping, prefix: str):
    cells = sorted(k for k in params if k.startswith("lstm_"))
    for name in cells:
        i = name.split("_")[1]
        lstm_cell(out, params[name], f"{prefix}all_cells.{i}")
        out[f"{prefix}all_initial_hidden_states.{i}"] = _f32(params[f"initial_hidden_{i}"])[None]
        out[f"{prefix}all_initial_hidden_cell_states.{i}"] = _f32(params[f"initial_cell_{i}"])[None]
    _linear(out, params["backbone"], f"{prefix}mlp_backbone.0")
    heads = ("rotation_head", "translation_head", "style_head", "deformation_head")
    for index, head in enumerate(heads):
        _linear(out, params[head], f"{prefix}mlp_heads.{index}")
    known = cells + ["backbone", *heads] + [f"initial_{k}_{n.split('_')[1]}" for n in cells for k in ("hidden", "cell")]
    _check_keys(params, known, prefix)


def action_network(out: Dict, params: Mapping, stats: Mapping, prefix: str, exact: bool = True):
    layers = sorted(k for k in params if k.startswith("mlp_"))
    for name in layers:
        i = int(name.split("_")[1])
        _linear(out, params[name], f"{prefix}mlp_backbone.{3 * i}")
        bn = f"{prefix}mlp_backbone.{3 * i + 1}"
        out[f"{bn}.gamma"] = _f32(params[f"bn_{i}"]["scale"])
        out[f"{bn}.beta"] = _f32(params[f"bn_{i}"]["bias"])
        out[f"{bn}.running_mean"] = _f32(stats[f"bn_{i}"]["mean"])
        out[f"{bn}.running_std"] = running_std(stats[f"bn_{i}"]["var"], exact)
    for head in ("mean_fc", "log_variance_fc", "final_fc"):
        _linear(out, params[head], f"{prefix}{head}")
    _check_keys(params, layers + [f"bn_{n.split('_')[1]}" for n in layers] + ["mean_fc", "log_variance_fc",
                                                                             "final_fc"], prefix)


def playable_state_dict(variables: Mapping, centroids: Sequence[np.ndarray], environment: Mapping = None,
                        scene=None, exact: bool = True) -> Dict[str, np.ndarray]:
    """A phase-3 PlayableEnvironmentModel's flax variables (its
    `animation_model_i` subtrees; discriminators are not part of the
    reference's playable checkpoint) and per-animation-model centroids in
    the reference's layout (`object_animation_models.i.`); with
    `environment` (and its `scene`), the frozen environment model under
    `environment_model.` too. `exact=False` lets a masked batch norm's
    variance that no float32 std gives exactly take the nearest std (the
    play path does not read the action networks)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    animation = sorted((k for k in params if k.startswith("animation_model_")), key=lambda k: int(k.split("_")[-1]))
    unknown = set(params) - set(animation)
    if unknown:
        raise KeyError(f"playable model: no reference layout for {sorted(unknown)} (discriminators are not saved)")
    for name in animation:
        i = name.split("_")[-1]
        prefix = f"object_animation_models.{i}."
        action_network(out, params[name]["action_network"], stats[name]["action_network"],
                       prefix + "action_network.", exact)
        dynamics_network(out, params[name]["dynamics_network"], prefix + "dynamics_network.")
        out[prefix + "centroid_estimator.estimated_centroids"] = _f32(centroids[int(i)])
    if environment is not None:
        for key, value in environment_state_dict(environment, scene).items():
            out[f"environment_model.{key}"] = value
    return out


def torch_checkpoint(state_dict: Mapping[str, np.ndarray], path: str, data_parallel: bool = False) -> str:
    """Write `state_dict` as the reference's trainer does, {"model":
    state_dict} through torch.save (with DataParallel's `module.` prefix
    on every key when `data_parallel`). :return: the path."""
    import torch

    prefix = "module." if data_parallel else ""
    torch.save({"model": {prefix + k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}, "step": 0}, path)
    return path
