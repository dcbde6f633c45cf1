"""The Minecraft family (configs/minecraft.yaml), the port against the JAX
package on the CPU, on a shrunken copy of the published config
(`tiny_minecraft_dict`: NeRFs 3x32 with 24 outputs, benders 2x16, style 8,
deformation 4, the v9 autoencoder at bottleneck 16 with one block, 32x48
frames; the sample counts cut from 16 / 1 / 32 to 4 / 1 / 8, which keeps
the background below the players, as the overlap fix's interval quirk
needs; the learned pose encoder at its fixed published widths on 32x32
crops):

- `SkyboxNerfMLP` (eval and train statistics) at 1e-5;
- `overlap_fix_mask` / `apply_overlap_fix` exactly;
- `render_rays_fast` with the skybox, the overlap fix over the uncompacted
  background and two compacted players of one object model, against JAX's
  `render_rays_fast(interpret=True)` at 5e-3 (the B1 path's bf16 operands,
  as tests/test_torch_port_render.py), the players inside the background
  slab so that the fix masks samples;
- the v9 decoder's `decode` at 1e-4, at Minecraft's downsampling (2, 1)
  and at (3, 1), which adds the `mid_res` blocks;
- `ObjectParametersEncoderV4`, eval and train (running statistics
  updated), with an invalid box and yaw offsets on both sides of the
  +-pi/4 wrap: rotations and translations at 1e-5 of their scale, the
  running statistics at 1e-5;
- the eval-mode `compute_scene_encoding` of a Minecraft batch (written by
  data.synthetic with its MINECRAFT_GEOMETRY) at 1e-5;
- `render_frame_fast` of the scene, decoder included, at 1e-2 (as
  tests/test_torch_port_play.py);
- one phase-3 generator step (minecraft.yaml's playable training: no GAN,
  so no discriminators) over that batch's JAX encoding, with JAX's draws
  replayed, at tests/test_torch_port_phase3.py's tolerances;
- strict loads of the whole tree (composer with the skybox, object
  encoders, the pose CNN, the v9 decoder).

The frames compared here come from fixed encodings, so the players keep
their positional benders; frames of data-derived encodings would need
them zeroed (ROADMAP.md §C, tests/test_torch_port_encode.py).

The JAX package cannot build a playable model with more animation models
than dynamic object models (it looks up one object model per animation
model), which minecraft.yaml has: two players of one object model, one
animation model each. The phase-3 comparison therefore runs a scene with
one animation model, which the two players share in both packages; the
port's per-object mapping for the published config is held by
`test_two_animation_models_move_one_object_model_each_player`.
"""

import copy
import dataclasses
import functools
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.core import compositing as jax_compositing
from playableenvironments_tpu.models.autoencoder import MultiresAutoencoder as JaxAutoencoder
from playableenvironments_tpu.models.nerf import SkyboxNerfMLP as JaxSkybox
from playableenvironments_tpu.models.parameter_encoders import ObjectParametersEncoderV4 as JaxPoseEncoder
from playableenvironments_tpu.render import fast as jax_fast
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.render.playable_model import PlayableEnvironmentModel as JaxPlayable
from playableenvironments_tpu.scene.encoding import SceneEncoding as JaxEncoding
from playableenvironments_tpu.train import trainer_playable as jtrainer
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.cli import common
from playableenvironments_tpu_torch.cli.play import InteractiveSession
from playableenvironments_tpu_torch.compat.from_flax import (
    load_environment_model,
    load_flax_tree,
    load_playable,
    load_playable_extra,
)
from playableenvironments_tpu_torch.core import compositing
from playableenvironments_tpu_torch.data import synthetic
from playableenvironments_tpu_torch.data.batching import collate
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.models.autoencoder import MultiresAutoencoder
from playableenvironments_tpu_torch.models.nerf import SkyboxNerfMLP
from playableenvironments_tpu_torch.models.parameter_encoders import (
    ObjectParametersEncoderV4,
    normalize_angle_range,
)
from playableenvironments_tpu_torch.render import fast
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.train import trainer_playable
from test_torch_port_composer import Replay, recorded_draws
from torch_port_scenes import init_with_composer, jax_batch
from test_torch_port_phase3 import check_parameters, gradient_tolerances, seeded_tree
from test_torch_port_play import _perturbed
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
IMAGE = (32, 48)
STRIDES = (4, 8)
FOCAL = 48.0  # the focal stored with the frames; minecraft.yaml renders at 0.5 of it
MULTIPLIER = 0.5
BF16_TOL = dict(atol=5e-3, rtol=5e-3)
F32 = dict(rtol=1e-5, atol=1e-5)
BS, T = 4, 4
NO_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SAMPLES = {16: 4, 1: 1, 32: 8}  # background, skybox, players


def tiny_minecraft_dict(animation_models=2, edge_to_center_distance=0.3):
    """configs/minecraft.yaml cut to test widths (module docstring). The pose
    encoder's `edge_to_center_distance` is raised from 0 so that the
    translation reads the wrapped yaw offset."""
    d = yaml.safe_load((REPO / "configs" / "minecraft.yaml").read_text())
    model = d["model"]
    model["autoencoder"].update(bottleneck_features=16, bottleneck_blocks=1)
    for block in model["object_models"]:
        block.update(style_features=8, deformation_features=4,
                     positions_count_coarse=SAMPLES[block["positions_count_coarse"]])
        block["nerf_model"].update(
            layers_width=32, backbone_layers_count=3, skip_layer_idx=2, output_features=24,
            position_encoder={"octaves": 3, "append_original": True},
        )
        if "positional" in block["ray_bender_model"]["architecture"]:
            block["ray_bender_model"].update(
                layers_width=16, layers_count=2, skip_layer_idx=1,
                position_encoder={"octaves": 2, "append_original": True, "num_steps": 100},
            )
    for block in model["object_encoders"]:
        v5 = block["architecture"].endswith("v5")
        block.update(style_features=8, deformation_features=4, input_size=[16, 32] if v5 else [16, 16])
    model["object_parameters_encoder"][2].update(input_size=[32, 32],
                                                 edge_to_center_distance=edge_to_center_distance)
    animation = d["playable_model"]["object_animation_models"][:animation_models]
    for block in animation:
        block.update(style_features=8, deformation_features=4, actions_count=3, action_space_dimension=2)
        block["dynamics_network"]["output_features"] = 16
        block["action_network"].update(layers_width=8, layers_count=1)
    d["playable_model"]["object_animation_models"] = animation
    return d


def scenes(**kwargs):
    d = tiny_minecraft_dict(**kwargs)
    return (jax_config.scene_from_dict(d["model"], d["playable_model"]),
            port_config.scene_from_dict(d["model"], d["playable_model"]))


def encoding_arrays(seed=0, objects=4):
    """A frame-0 state at data.synthetic's Minecraft camera: both players
    on the ground inside the background slab, turned about y."""
    rng = np.random.default_rng(seed)
    geometry = synthetic.MINECRAFT_GEOMETRY
    translations = np.zeros((1, 1, objects, 3), np.float32)
    translations[:, :, 2] = [-1.0, 0.0, -1.0]
    translations[:, :, 3] = [1.5, 0.0, -0.5]
    rotations = np.zeros((1, 1, objects, 3), np.float32)
    rotations[:, :, 2:, 1] = rng.uniform(-1.0, 1.0, 2)
    return dict(
        camera_rotations=np.asarray([[[geometry["camera_rotation"]]]], np.float32),
        camera_translations=np.asarray([[[geometry["camera_translation"]]]], np.float32),
        focals=np.full((1, 1, 1), FOCAL, np.float32),
        object_rotations=rotations,
        object_translations=translations,
        object_style=rng.normal(size=(1, 1, objects, 8)).astype(np.float32),
        object_deformation=rng.normal(size=(1, 1, objects, 4)).astype(np.float32),
        object_in_scene=np.ones((1, 1, objects), bool),
    )


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A Minecraft-geometry test split: 2 videos of 6 frames at 32x48."""
    root = synthetic.make_two_player_dataset(
        str(tmp_path_factory.mktemp("minecraft")), videos=2, frames=6, height=IMAGE[0], width=IMAGE[1],
        focal=FOCAL, seed=5, splits=("test",), **synthetic.MINECRAFT_GEOMETRY,
    )
    return MulticameraVideoDataset(str(pathlib.Path(root) / "test"), observations_count=T)


@pytest.fixture(scope="module")
def batch(dataset):
    return collate([dataset[i] for i in range(BS)])


@pytest.fixture(scope="module")
def variables(batch):
    """The whole environment tree of the tiny scene from jitted JAX inits
    (composer, object encoders, pose CNN, the v9 autoencoder's encoder and
    decoder), perturbed."""
    jscene, _ = scenes()
    jmodel = JaxEnvironmentModel(jscene, focal_length_multiplier=MULTIPLIER)
    key = jax.random.PRNGKey(0)
    init = jax.jit(lambda k, *a: jmodel.init(k, *a, method=init_with_composer))
    tree = jax.device_get(init(key, *jax_batch(batch).environment_model_args()))
    ae = JaxAutoencoder(jscene.autoencoder)
    ae_vars = jax.device_get(jax.jit(lambda k: ae.init(k, jnp.zeros((1,) + IMAGE + (3,)), train=False))(key))
    tree = {kind: {**tree[kind], "autoencoder": ae_vars[kind]} for kind in ("params", "batch_stats")}
    return _perturbed(tree, np.random.default_rng(3))


def port_environment(variables, **kwargs):
    _, pscene = scenes(**kwargs)
    model = EnvironmentModel(pscene, MULTIPLIER, device="cpu")
    assert load_environment_model(model, variables) == []
    return model, model.autoencoder


def frame_args(arrays):
    """render_rays_fast's inputs for the tiny frame, from the port's own
    frame geometry, as numpy."""
    encoding = SceneEncoding(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
    return [np.ascontiguousarray(a.numpy()) for a in fast.frame_rays(encoding, IMAGE, STRIDES, MULTIPLIER)]


def test_published_minecraft_config_builds_at_full_width():
    """cli/common.py builds configs/minecraft.yaml: the skybox NeRF, the
    pose CNN, the v9 autoencoder, two animation models over one player
    model, and its phase-1 and phase-2 trainer configurations (the decoder
    path at patch 48 on the autoencoder's strides)."""
    cfg = common.load_yaml(str(REPO / "configs" / "minecraft.yaml"))
    model = common.build_environment_model(cfg, device="cpu")
    scene = model.scene
    assert isinstance(model.composer.object_model(1).nerf, SkyboxNerfMLP)
    assert model.composer.object_model(1).nerf.backbone_0.in_features == 126  # PE(origin, direction)
    assert isinstance(model.parameters_encoder_2, ObjectParametersEncoderV4)
    assert [n for n, _ in model.named_children()] == [
        "composer", "object_encoder_0", "object_encoder_1", "object_encoder_2", "parameters_encoder_2", "autoencoder"]
    decoder = MultiresAutoencoder(scene.autoencoder, device="cpu").decoder
    assert scene.autoencoder.variant == "v9" and not any("mid_res" in n for n, _ in decoder.named_children())
    playable = PlayableEnvironmentModel(scene, device="cpu")
    assert playable.animation_indexes == (0, 1)
    assert common.playable_training_config(cfg).loss_weights.gan == 0.0
    phase2 = common.synthesis_training_config(cfg)
    assert (phase2.decode_patches, phase2.patch_size, phase2.patch_strides) == (True, 48, (4, 8))
    assert (phase2.autoencoder_learning_rate, phase2.frozen_autoencoder_steps) == (1e-4, 1000)
    phase1 = common.autoencoder_training_config(cfg)
    assert (phase1.perceptual_lambda, phase1.kl_lambda) == (0.01, 5e-6)


@pytest.mark.parametrize("train", [False, True])
def test_skybox_mlp_matches_jax(rng, train):
    jscene, pscene = scenes()
    cfg = jscene.object_models[1]
    origins = rng.normal(size=(3, 5, 3)).astype(np.float32) * 20
    directions = rng.normal(size=(3, 5, 3)).astype(np.float32)
    style = rng.normal(size=(3, 1, 8)).astype(np.float32)
    mask = rng.uniform(size=(3, 5)) < 0.7
    net = JaxSkybox(cfg.nerf, cfg.style_features, cfg.bounding_box)
    tree = jax.device_get(net.init(jax.random.PRNGKey(0), origins, directions, style, mask, True))
    tree = _perturbed(dict(tree), np.random.default_rng(1))
    ref, mutated = net.apply(tree, origins, directions, style, mask, not train, mutable=["batch_stats"])
    port = SkyboxNerfMLP(pscene.object_models[1].nerf, 8, device="cpu")
    load_flax_tree(port, tree["params"], tree["batch_stats"])
    got = port(*map(torch.from_numpy, (origins, directions)), cfg.bounding_box, torch.from_numpy(style),
               torch.from_numpy(mask), not train)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ref[0]), **F32)
    np.testing.assert_array_equal(got[1].numpy(), np.full((3, 5), 10.0, np.float32))
    if train:
        state = port.state_dict()
        for name in ("adain_0", "adain_1"):
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(state[f"{name}.norm.{leaf}"].numpy(),
                                           np.asarray(mutated["batch_stats"][name]["norm"][leaf]), **F32)


@pytest.mark.parametrize("static,dynamic", [(4, 8), (8, 4)])
def test_overlap_fix_matches_jax(rng, static, dynamic):
    """The mask (including its upper end at the static sample count) and
    the fix's five outputs, exactly."""
    static_t = np.sort(rng.uniform(0, 10, (3, 6, static)), axis=-1).astype(np.float32)
    dynamic_t = np.sort(rng.uniform(2, 8, (3, 6, dynamic)), axis=-1).astype(np.float32)
    mask = compositing.overlap_fix_mask(torch.from_numpy(static_t), torch.from_numpy(dynamic_t))
    ref = jax_compositing.overlap_fix_mask(jnp.asarray(static_t), jnp.asarray(dynamic_t))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref))
    assert 0 < int(mask.sum()) < mask.numel()
    inputs = [rng.normal(size=s).astype(np.float32) for s in
              [(3, 6, static), (3, 6, static), (3, 6, static, 3), (3, 6, static, 3), (3, 6, static), (3, 6, 3)]]
    got = compositing.apply_overlap_fix(*map(torch.from_numpy, inputs), mask)
    want = jax_compositing.apply_overlap_fix(*map(jnp.asarray, inputs), ref)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def masked_background_samples(pscene, args):
    """How many background samples the overlap fix masks in this frame."""
    origins, directions, normals, w2o, _, _, in_scene = (torch.from_numpy(a) for a in args)
    lead = directions.shape[:-2]
    flat = lambda x, tail: x.expand(lead + tail).reshape((-1,) + tail)  # noqa: E731
    o, d, n = flat(origins, (3,)), directions.reshape((-1,) + directions.shape[-2:]), flat(normals, (3,))
    w2o, in_scene = flat(w2o, (4, 4, 4)), flat(in_scene, (4,))
    t = [fast.object_samples(pscene.object_models[m], o, d, n, w2o[:, i], in_scene[:, i])[3]
         for i, m in enumerate((0, 1, 2, 2))]
    return int((compositing.overlap_fix_mask(t[0], t[2]) | compositing.overlap_fix_mask(t[0], t[3])).sum())


def test_render_rays_fast_matches_jax(variables):
    """Every integral of every object and of the composite at 5e-3; the
    overlap fix masks background samples and changes the frame."""
    jscene, pscene = scenes()
    model, _ = port_environment(variables)
    args = frame_args(encoding_arrays())
    ref = jax.jit(lambda *a: jax_fast.render_rays_fast(jscene, variables, *a, interpret=True))(*map(jnp.asarray, args))
    got = fast.render_rays_fast(pscene, model.composer, *map(torch.from_numpy, args))
    assert set(got["coarse"]) == set(ref["coarse"]) == {"global", "object_0", "object_1", "object_2", "object_3"}
    for part, fields in got["coarse"].items():
        for field, value in fields.items():
            np.testing.assert_allclose(value.numpy(), np.asarray(ref["coarse"][part][field]), **BF16_TOL,
                                       err_msg=f"{part}.{field}")
    assert masked_background_samples(pscene, args) > 0
    assert got["coarse"]["object_2"]["opacity"].max() > 0.1 and got["coarse"]["object_1"]["opacity"].min() > 0.5
    off = fast.render_rays_fast(dataclasses.replace(pscene, fix_object_overlaps=False), model.composer,
                                *map(torch.from_numpy, args))
    assert not torch.allclose(off["coarse"]["global"]["integrated_features"],
                              got["coarse"]["global"]["integrated_features"], atol=1e-4)


def test_overlap_fix_refuses_a_compacted_static_object(variables):
    _, pscene = scenes()
    model, _ = port_environment(variables)
    background = dataclasses.replace(pscene.object_models[0], ray_compaction=0.5)
    scene = dataclasses.replace(pscene, object_models=(background,) + pscene.object_models[1:])
    with pytest.raises(ValueError, match="ray_compaction"):
        fast.render_rays_fast(scene, model.composer, *map(torch.from_numpy, frame_args(encoding_arrays())))


@pytest.mark.parametrize("downsampling", [(2, 1), (3, 1)])
def test_v9_decode_matches_jax(rng, downsampling):
    """Minecraft's (2, 1) adds a ReLU after each bottleneck block; (3, 1)
    also the mid_res blocks after the second-to-last upsampling."""
    jscene, _ = scenes()
    cfg = dataclasses.replace(jscene.autoencoder, downsampling_layers_count=downsampling, bottleneck_blocks=2)
    shapes = [(2, 32 // s, 64 // s, c) for s, c in zip(
        [2 ** downsampling[0], 2 ** sum(downsampling)],
        [16 // 2 ** downsampling[1], 16])]
    levels = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ae = JaxAutoencoder(cfg)
    tree = jax.device_get(jax.jit(lambda k: ae.init(k, [jnp.asarray(x) for x in levels], False,
                                                    method=JaxAutoencoder.decode))(jax.random.PRNGKey(1)))
    tree = _perturbed(dict(tree), np.random.default_rng(2))
    ref = ae.apply(tree, [jnp.asarray(x) for x in levels], False, method=JaxAutoencoder.decode)
    port = MultiresAutoencoder(port_config.AutoencoderConfig(**dataclasses.asdict(cfg)), device="cpu")
    load_flax_tree(port.decoder, tree["params"]["decoder"], tree["batch_stats"]["decoder"])
    assert any(n.startswith("mid_res") for n, _ in port.decoder.named_children()) == (downsampling[0] >= 3)
    got = port.decode([torch.from_numpy(x) for x in levels])
    assert got.shape == (2, 32, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def pose_inputs(rng, n=4):
    """Frames of different contrast (so that the crops' features, and with
    them the yaw offsets, spread across the +-pi/4 wrap), a yawed camera per
    frame, focals and 2 boxes a frame, the second box of the last frame
    invalid."""
    contrast = np.asarray([0.1, 1.0, 3.0, -2.0], np.float32)[:n, None, None, None]
    observations = rng.uniform(0, 1, (n, 32, 48, 3)).astype(np.float32) * contrast
    camera_rotations = np.stack([np.full(n, -0.35), rng.uniform(-1, 1, n), np.zeros(n)], -1).astype(np.float32)
    translations = np.tile(np.asarray([[3.0, 3.5, 9.0]], np.float32), (n, 1))
    from playableenvironments_tpu.core.transforms3d import euler_translation_to_matrix, invert_rigid

    w2c = np.array(invert_rigid(euler_translation_to_matrix(jnp.asarray(camera_rotations),
                                                              jnp.asarray(translations))))
    left = rng.uniform(0.1, 0.7, (n, 2))
    top = rng.uniform(0.1, 0.4, (n, 2))
    boxes = np.stack([left, top, left + 0.2, top + rng.uniform(0.3, 0.5, (n, 2))], -1).astype(np.float32)
    validity = np.ones((n, 2), bool)
    validity[-1, 1] = False
    return observations, w2c, camera_rotations, np.full(n, 24.0, np.float32), boxes, validity


@pytest.mark.parametrize("train", [False, True])
def test_pose_encoder_v4_matches_jax(rng, train):
    jscene, pscene = scenes()
    cfg = jscene.parameter_encoders[2]
    inputs = pose_inputs(rng)
    module = JaxPoseEncoder(cfg)
    tree = jax.device_get(jax.jit(lambda k, *a: module.init(k, *a, train=False))(jax.random.PRNGKey(0), *inputs))
    tree = _perturbed(dict(tree), np.random.default_rng(4))
    (rotations, translations), mutated = jax.jit(
        lambda v, *a: module.apply(v, *a, train=train, mutable=["batch_stats"]))(tree, *inputs)
    port = ObjectParametersEncoderV4(pscene.parameter_encoders[2], device="cpu")
    load_flax_tree(port, tree["params"], tree["batch_stats"])
    with torch.no_grad():
        got = port(*map(torch.from_numpy, inputs), train=train)
    for g, r in zip(got, (rotations, translations)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))
    offsets = np.asarray(rotations)[..., 1] - inputs[2][:, None, 1]
    valid = inputs[5]
    wrapped = normalize_angle_range(torch.from_numpy(offsets[valid]), -math.pi / 4, math.pi / 4).numpy()
    assert (np.abs(wrapped - offsets[valid]) > 1e-3).any() and (np.abs(wrapped - offsets[valid]) < 1e-6).any()
    assert not np.asarray(rotations)[~valid].any() and not np.asarray(translations)[~valid].any()
    state = port.state_dict()
    for path, leaf in jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]):
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + [{"mean": "running_mean", "var": "running_var"}[keys[-1]]])
        np.testing.assert_allclose(state[name].numpy(), np.asarray(leaf), rtol=1e-5, atol=1e-5, err_msg=name)
    changed = any(not np.array_equal(np.asarray(leaf), functools.reduce(lambda t, p: t[p.key], path,
                                                                         tree["batch_stats"]))
                  for path, leaf in jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]))
    assert changed == train


@pytest.fixture(scope="module")
def jax_encoding(variables, batch):
    jscene, _ = scenes()
    jmodel = JaxEnvironmentModel(jscene, focal_length_multiplier=MULTIPLIER)
    apply = jax.jit(lambda v, *a: jmodel.apply(v, *a, shuffle_style=False, train=False,
                                               method=JaxEnvironmentModel.compute_scene_encoding,
                                               mutable=["batch_stats"])[0][0])
    return jax.device_get(apply(variables, *jax_batch(batch).environment_model_args()))


def test_minecraft_scene_encoding_matches_jax(variables, batch, jax_encoding):
    """The eval-mode encoding of a Minecraft batch (the learned pose encoder
    over both players) at 1e-5; no running statistic changes."""
    model, _ = port_environment(variables)
    before = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        encoding, _ = model.compute_scene_encoding(*batch.environment_model_args(), train=False)
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
    for field in vars(encoding):
        got, ref = getattr(encoding, field).numpy(), np.asarray(getattr(jax_encoding, field))
        assert got.shape == ref.shape == (BS, T) + ref.shape[2:], field
        np.testing.assert_allclose(got, ref, **F32, err_msg=field)
    yaw = encoding.object_rotations[..., 2:, 1]
    assert bool((yaw != 0).all()) and bool((encoding.object_rotations[..., 2:, [0, 2]] == 0).all())


def test_render_frame_fast_matches_jax(variables):
    """The whole frame (skybox, overlap fix, one B1 group of background and
    both players, v9 decoder) at 1e-2."""
    jscene, pscene = scenes()
    model, autoencoder = port_environment(variables)
    arrays = encoding_arrays()
    ref = jax.jit(lambda e: jax_fast.render_frame_fast(
        jscene, variables, e, IMAGE, STRIDES, MULTIPLIER, interpret=True))(
        JaxEncoding(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    encoding = SceneEncoding(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    got = fast.render_frame_fast(pscene, model.composer, autoencoder, encoding, IMAGE, STRIDES, MULTIPLIER)
    assert got.shape == (1, 1, 1) + IMAGE + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-2, rtol=0)
    assert got.std() > 1e-3


def test_two_animation_models_move_one_object_model_each_player(variables):
    """minecraft.yaml's two animation models over one player model: the play
    step moves player k with animation model k."""
    _, pscene = scenes()
    model, autoencoder = port_environment(variables)
    playable = PlayableEnvironmentModel(pscene, device="cpu", seed=4)
    assert playable.animation_indexes == (0, 1)
    session = InteractiveSession(pscene, model.composer, autoencoder, playable, IMAGE, STRIDES, MULTIPLIER,
                                 environment_model=model)
    arrays = encoding_arrays()
    session.start(SceneEncoding(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
    frame = session.step([1, 2])
    assert frame.shape == IMAGE + (3,) and np.isfinite(frame).all()
    for dynamic_idx, action in enumerate((1, 2)):
        net = getattr(playable, f"animation_model_{dynamic_idx}").dynamics_network
        one_hot = torch.nn.functional.one_hot(torch.tensor([action]), 3).float()
        with torch.no_grad():
            _, (rot, trans, _, _) = net(None, *(torch.from_numpy(arrays[f][:, 0, 2 + dynamic_idx]) for f in (
                "object_rotations", "object_translations", "object_style", "object_deformation")),
                one_hot, torch.zeros(1, 2))
        torch.testing.assert_close(session.encoding.object_translations[:, 0, 2 + dynamic_idx], trans)
        torch.testing.assert_close(session.encoding.object_rotations[:, 0, 2 + dynamic_idx], rot)


GT_START = 2


def phase3_configs():
    d = tiny_minecraft_dict(animation_models=1)
    port_cfg = dataclasses.replace(common.playable_training_config(d), ground_truth_observations_start=GT_START,
                                   observations_count=T)
    fields = {f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(port_cfg) if f.name != "loss_weights"}
    jax_cfg = jtrainer.PlayableTrainingConfig(
        **fields, loss_weights=jtrainer.PlayableLossWeights(**dataclasses.asdict(port_cfg.loss_weights)))
    return d, port_cfg, jax_cfg


@pytest.fixture(scope="module")
def jax_phase3(jax_encoding):
    """The JAX generator step (minecraft.yaml's loss weights: no GAN, no
    ACMV, no discriminators) over the batch's Minecraft encoding: the state
    before, the gradients, metrics, state after and the recorded draws."""
    d, _, cfg = phase3_configs()
    jscene = jax_config.scene_from_dict(d["model"], d["playable_model"])
    trainer = jtrainer.PlayableTrainer(JaxEnvironmentModel(jscene), JaxPlayable(jscene), cfg)
    encoding = JaxEncoding(**{k: jnp.asarray(v) for k, v in vars(jax_encoding).items()})
    shapes = jax.eval_shape(lambda e: trainer.init_state_from_encoding(jax.random.PRNGKey(0), e, {}, {}), encoding)
    rng = np.random.default_rng(6)
    params = seeded_tree(shapes.params, rng)
    stats = seeded_tree(shapes.batch_stats, rng)
    extra = {**shapes.extra, "centroids": {"0": rng.normal(size=(3, 2)).astype(np.float32)},
             "mi_matrices": {"0": np.full((3, 3), 1 / 9, np.float32)},
             "environment": {"params": {}, "batch_stats": {}}}
    state = shapes.replace(params=params, batch_stats=stats, opt_state=shapes.tx.init(params), extra=extra,
                           step=jnp.asarray(0, jnp.int32))
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def run(state, key):
        with recorded_draws(("normal", "gumbel")) as draws:
            def loss_fn(p):
                return trainer.compute_losses(p, state.batch_stats, state.extra, encoding, key, state.step)

            (_, (metrics, new_stats, new_extra, _, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params)
            after = state.apply_gradients(grads).replace(batch_stats=new_stats, extra=new_extra)
        names[:] = [name for name, _ in draws]
        return grads, metrics, {"params": after.params, "batch_stats": after.batch_stats,
                                "centroids": after.extra["centroids"], "mi_matrices": after.extra["mi_matrices"]}, [
            v for _, v in draws]

    grads, metrics, after, values = jax.device_get(run(state, jax.random.PRNGKey(3)))
    before = {"params": params, "batch_stats": stats, "centroids": extra["centroids"],
              "mi_matrices": extra["mi_matrices"]}
    return before, grads, metrics, after, [(n, np.asarray(v)) for n, v in zip(names, values)]


def test_phase3_step_over_a_minecraft_encoding_matches_jax(jax_encoding, jax_phase3):
    """fused_step (the generator step alone: minecraft.yaml sets no GAN
    weight) with JAX's draws: the loss and metrics 1e-5 relative (1e-6
    absolute: the mutual-information loss is a difference of entropies of
    ~log 3 that cancels to ~1e-3 here, so the f32 rounding of its terms,
    ~1e-7, shows in full), every
    gradient at 1e-4 of its tensor's largest (tests/test_torch_port_phase3.py),
    the parameters after Adam as check_parameters holds them, the running
    statistics, centroids and MI matrices 1e-5; B4/B5's plain versions run
    the rollout at style width 8 here, 32 at the published width."""
    d, port_cfg, _ = phase3_configs()
    before, jgrads, jmetrics, jafter, draws = jax_phase3
    pscene = port_config.scene_from_dict(d["model"], d["playable_model"])

    def port_model(params, stats):
        model = PlayableEnvironmentModel(pscene, device="cpu")
        assert load_playable(model, {"params": params, "batch_stats": stats}) == []
        return model

    model = port_model(before["params"], before["batch_stats"])
    assert model.animation_indexes == (0, 0) and not model.with_discriminators
    trainer = trainer_playable.PlayableTrainer(model, port_cfg)
    load_playable_extra(trainer, before)
    encoding = SceneEncoding(**{k: torch.from_numpy(np.array(v)) for k, v in vars(jax_encoding).items()})
    replay = Replay(draws)
    metrics = trainer.fused_step(encoding, replay)
    assert not replay.draws and replay.streams == ["action_sampling", "action_sampling", "gumbel"] * 4
    assert set(metrics) == set(jmetrics) and "discriminator_loss" not in metrics
    for name, value in metrics.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jmetrics[name]), rtol=1e-5, atol=1e-6, err_msg=name)
    grads = {n: p.grad for n, p in model.named_parameters()}
    ref_grads = port_model(jgrads, before["batch_stats"]).state_dict()
    atol = gradient_tolerances(ref_grads, grads)
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(), rtol=0, atol=atol[name], err_msg=name)
    state, ref = model.state_dict(), port_model(jafter["params"], jafter["batch_stats"]).state_dict()
    check_parameters(state, ref, ref_grads, list(grads))
    for name in (n for n in state if n not in grads):
        np.testing.assert_allclose(state[name].numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    for key in ("centroids", "mi_matrices"):
        np.testing.assert_allclose(getattr(trainer, key)[0].numpy(), jafter[key]["0"], rtol=1e-5, atol=1e-6)


def test_strict_loads_of_the_minecraft_tree(variables):
    """Every leaf of the tree lands (port_environment asserts it); a missing
    pose-CNN leaf, an unknown subtree or a misshapen skybox leaf raises."""
    port_environment(variables)
    _, pscene = scenes()
    model = EnvironmentModel(pscene, MULTIPLIER, device="cpu")
    missing = copy.deepcopy(variables)
    del missing["params"]["parameters_encoder_2"]["rotation_head"]
    with pytest.raises(KeyError):
        load_environment_model(model, missing)
    unknown = copy.deepcopy(variables)
    unknown["params"]["parameters_encoder_7"] = unknown["params"]["parameters_encoder_2"]
    with pytest.raises(KeyError):
        load_environment_model(model, unknown)
    misshapen = copy.deepcopy(variables)
    misshapen["params"]["composer"]["object_model_1"]["nerf"]["backbone_0"]["kernel"] = np.zeros((63, 32), np.float32)
    with pytest.raises(ValueError):
        load_environment_model(model, misshapen)
