"""Phase 2 with the options the published configs leave off, the port
against the JAX package on the CPU, at tiny widths:

- `sample_pdf` and `weighted_ray_positions`: on the evenly spaced grid
  (ties between a draw and a CDF value included, and an all-zero weight
  row that takes the `denom < 1e-5` guard) and on replayed draws, at 1e-6;
  the new t values carry no gradient;
- the Hutchinson divergence of the positional bender (`compute_divergence`)
  on replayed probes: the divergences, the displacements and the
  gradients that a loss on both sends to the bender's parameters through
  the second-order graph, at 1e-5 of each tensor's largest; zero under
  `canonical_pose` and outside the box;
- the training composer's hierarchical fine pass, with shared and with
  separate fine fields, perturbation and the divergence on, every draw
  replayed in JAX's order: both passes' per-object and global integrals at
  1e-5 (and 1e-4 relative), the running statistics after it at 1e-5;
- the per-frame camera offsets: the table's gather (clipped indexes), its
  scales and its eval-mode zeros exactly; the weight bridge for the fine
  fields and the table, strictly;
- whole phase-2 steps with every option on (separate or shared fine
  fields, divergence 0.1, camera offsets in their own rate group,
  perturbation and the style shuffle on the direct-ray path): the direct
  path against JAX with `remat` (jax.checkpoint), the port with and
  without `remat`; the decoder path against JAX without. The port draws
  (its RngStreams on the CPU) and JAX replays the same numbers, so that
  the order of the draws is held too. Loss and metrics at 2e-4 relative,
  gradients at 2e-3 of each tensor's largest (the decoder path's bound,
  tests/test_torch_port_decoder.py) except the object encoders' (1e-2 of
  their largest on the direct path, 1e-1 on the decoder path),
  parameters after the step as there, running statistics at 1e-4. The
  wider bounds are measured on these seeded weights, and none is in the
  modules this file holds: the player's encoder crops 8x8, so its last
  blocks batch-normalize 16 values a channel (the trap that
  tests/test_torch_port_train.py states): its gradients sit up to 4.8e-3
  of their largest from JAX's on the direct path (2.3e-3 with the
  randomness off, the same with JAX's `remat` as without), the
  displacement-magnitude metrics 1.1e-4 relative and the player's AdaIN
  variances 3.7e-5 apart, and with a 32x32 crop the metrics come within
  1.3e-5 while every composer gradient stays within 2e-4. On the decoder
  path the background encoder's first blocks sit up to 6.4e-2 from JAX's,
  and 8.1e-3 with every option and the randomness off on the same weights;
- `remat` against the same step without it, in the port: the same loss,
  gradients and running statistics (the recompute replays the forward's
  draws and updates no statistic a second time), to 1e-6 relative;
- the decoder path's step and the composer-based frame path are in
  tests/test_torch_port_options_decoder.py (a file of its own, so that the
  two JAX steps compile in parallel test processes).
"""

import contextlib
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.core import rays as jrays
from playableenvironments_tpu.data.batching import Batch as JaxBatch
from playableenvironments_tpu.models.nerf import ObjectRadianceField as JaxField
from playableenvironments_tpu.render.composer import SceneComposer as JaxComposer
from playableenvironments_tpu.render.environment_model import CameraParametersStorage as JaxCameraStorage
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.train import trainer_synthesis as jax_trainer
from playableenvironments_tpu.train.state import create_train_state, make_optimizer
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model, load_flax_tree
from playableenvironments_tpu_torch.core import rays
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.models.nerf import ObjectRadianceField
from playableenvironments_tpu_torch.render.composer import SceneComposer
from playableenvironments_tpu_torch.render.environment_model import CameraParametersStorage, EnvironmentModel
from playableenvironments_tpu_torch.train import trainer_synthesis
from playableenvironments_tpu_torch.utils.random import RngStreams
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_decoder import NO_OPT, decoder_scene
from test_torch_port_decoder import batch_arrays as decoder_arrays
from test_torch_port_phase3 import gradient_tolerances, seeded_tree
from test_torch_port_train import batch_arrays, fused_scene, to_port

F32 = dict(rtol=1e-5, atol=1e-5)
STRIDES = (4, 8)
FINE = (3, 5)
WEIGHTS = dict(reconstruction=1.0, ray_object_distance=0.1, bounding_box=0.1, displacements_magnitude=0.1,
               divergence=0.1, opacity=0.01, attention=0.01, sharpness=0.01)
LEARNING_RATE, CAMERA_RATE = 5e-4, 1e-3
# Whole steps against JAX (module docstring): metrics relative, gradients
# in units of each tensor's largest, the player's object encoder apart.
METRIC_RTOL, GRADIENT_RTOL, STATS_TOL = 2e-4, 2e-3, 1e-4
ENCODER_RTOL = {"direct": 1e-2, "decoder": 1e-1}
CAMERA_MEMORY = 6
FIRST_STEP = 1


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, tol=F32, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol, err_msg=err_msg)


class RecordingStreams:
    """The port's CPU random streams, every draw kept (kind, stream, value)
    so that JAX can replay the same numbers (`draws_into_jax`)."""

    def __init__(self, seed):
        self.streams, self.draws = RngStreams(seed, "cpu"), []

    def _keep(self, kind, stream, value):
        self.draws.append((kind, stream, value.numpy().copy()))
        return value

    def uniform(self, stream, shape):
        return self._keep("uniform", stream, self.streams.uniform(stream, shape))

    def normal(self, stream, shape):
        return self._keep("normal", stream, self.streams.normal(stream, shape))

    def permutation(self, stream, n):
        return self._keep("permutation", stream, self.streams.permutation(stream, n))


@contextlib.contextmanager
def draws_into_jax(draws):
    """While JAX traces, jax.random.uniform / normal / permutation return
    the port's draws in order (constants of the traced program, so that they
    may be drawn inside jax.checkpoint); each must be of the kind and shape
    JAX asks for."""
    pending = list(draws)
    originals = {name: getattr(jax.random, name) for name in ("uniform", "normal", "permutation")}

    def replay(kind):
        def draw(key, shape_or_n=None, dtype=jnp.float32, *args, **kwargs):
            name, _, value = pending.pop(0)
            assert name == kind, (name, kind)
            if kind == "permutation":
                assert value.shape == (int(shape_or_n),), (value.shape, shape_or_n)
                return jnp.asarray(value, jnp.int32)
            assert tuple(value.shape) == tuple(shape_or_n), (value.shape, shape_or_n)
            return jnp.asarray(value, dtype)
        return draw

    for name in originals:
        setattr(jax.random, name, replay(name))
    try:
        yield pending
    finally:
        for name, fn in originals.items():
            setattr(jax.random, name, fn)


# ---- samplers ----------------------------------------------------------------


def pdf_inputs():
    rng = np.random.default_rng(0)
    bins = np.sort(rng.uniform(0.0, 5.0, (3, 4, 7)), axis=-1).astype(np.float32)
    weights = rng.random((3, 4, 6)).astype(np.float32)
    weights[0, 0] = 0.0  # all zero: the 1e-5 floor makes it uniform
    weights[0, 1] = 1.0  # equal weights: linspace draws tie with CDF values
    weights[1, 1, 2:] = 0.0  # flat CDF steps below the guard
    return bins, weights


@pytest.mark.parametrize("perturb", [False, True])
def test_sample_pdf_matches_jax(perturb):
    bins, weights = pdf_inputs()
    key = jax.random.PRNGKey(2)
    ref = jrays.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 9, perturb, key if perturb else None)
    u = t(jax.random.uniform(key, (3, 4, 9), dtype=jnp.float32)) if perturb else None
    got = rays.sample_pdf(t(bins), t(weights), 9, u)
    close(got, ref, dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("perturb", [False, True])
def test_weighted_ray_positions_match_jax(perturb):
    rng = np.random.default_rng(1)
    origins = rng.normal(size=(2, 3)).astype(np.float32)
    directions = rng.normal(size=(2, 5, 3)).astype(np.float32)
    reference_t = np.sort(rng.uniform(1.0, 6.0, (2, 5, 8)), axis=-1).astype(np.float32)
    weights = rng.random((2, 5, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jrays.weighted_ray_positions(*(jnp.asarray(a) for a in (origins, directions)), 6,
                                       jnp.asarray(reference_t), jnp.asarray(weights), perturb,
                                       key if perturb else None)
    u = t(jax.random.uniform(key, (2, 5, 6), dtype=jnp.float32)) if perturb else None
    w = t(weights).requires_grad_()
    got = rays.weighted_ray_positions(t(origins), t(directions), 6, t(reference_t), w, u)
    for g, r in zip(got, ref):
        close(g, r, dict(rtol=1e-6, atol=1e-6))
    assert got[1].shape == (2, 5, 14) and bool((got[1][..., 1:] >= got[1][..., :-1]).all())
    assert not got[0].requires_grad  # the new t values are detached from the weights


# ---- the divergence ------------------------------------------------------------


def player_cfg(scene=None):
    return (scene or fused_scene(use_fused_backbone=False)).object_models[1]


def test_divergence_matches_jax():
    """A loss on the divergences and displacements of the player's field:
    JAX takes e^T J e through `nn.vjp`, the port through a double backward
    on the same probe."""
    cfg = player_cfg()
    rng = np.random.default_rng(4)
    positions = rng.uniform(-0.7, 0.7, (2, 5, 4, 3)).astype(np.float32)
    positions[..., 2] += 1.0
    positions[0, 0, 0] = (3.0, 0.0, 1.0)  # outside the box
    origins = np.zeros((2, 5, 3), np.float32)
    directions = rng.normal(size=(2, 5, 3)).astype(np.float32)
    style = rng.normal(size=(2, cfg.style_features)).astype(np.float32)
    deformation = rng.normal(size=(2, cfg.deformation_features)).astype(np.float32)
    weights = rng.normal(size=positions.shape[:-1]).astype(np.float32)
    module = JaxField(cfg)
    args = [jnp.asarray(a) for a in (positions, origins, directions, style, deformation)]
    shapes = jax.eval_shape(lambda k: module.init({"params": k, "divergence": k}, *args, step=jnp.asarray(30),
                                                  compute_divergence=True), jax.random.PRNGKey(0))
    variables = {kind: seeded_tree(shapes[kind], np.random.default_rng(5)) for kind in shapes}
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def run(params):
        with recorded_draws(("normal",)) as draws:
            def loss_fn(p):
                (_, _, disp, div), _ = module.apply({"params": p, "batch_stats": variables["batch_stats"]}, *args,
                                                    step=jnp.asarray(30), compute_divergence=True,
                                                    rngs={"divergence": jax.random.PRNGKey(6)},
                                                    mutable=["batch_stats"])
                return jnp.sum(div * weights) + jnp.sum(disp ** 2), (div, disp)

            (_, (div, disp)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        names[:] = [n for n, _ in draws]
        return div, disp, grads, [v for _, v in draws]

    div, disp, grads, probes = jax.device_get(run(variables["params"]))
    assert names == ["normal"]
    field = ObjectRadianceField(to_port(cfg))
    load_flax_tree(field, variables["params"], variables["batch_stats"])
    field.train()
    probe = t(probes[0])
    _, _, got_disp, got_div = field(t(positions), t(style), t(deformation), 30, compute_divergence=True,
                                    ray_origins=t(origins)[..., 0, :], ray_directions=t(directions),
                                    divergence_probe=probe)
    close(got_div, div, err_msg="divergences")
    close(got_disp, disp, err_msg="displacements")
    assert float(got_div.detach()[0, 0, 0]) == 0.0 and float(np.abs(div).max()) > 1e-3
    (torch.sum(got_div * t(weights)) + torch.sum(got_disp ** 2)).backward()
    ref = {".".join(path): np.asarray(v) for path, v in _flat(grads["ray_bender"])}
    for name, param in field.ray_bender.named_parameters():
        key = name.replace("weight", "kernel")
        ref_grad = ref[key].T if param.dim() == 2 else ref[key]
        scale = np.abs(ref_grad).max()
        assert scale > 0, name
        np.testing.assert_allclose(param.grad.numpy(), ref_grad, rtol=0, atol=1e-5 * scale, err_msg=name)
    _, _, canonical_disp, canonical = field(t(positions), t(style), t(deformation), 30, canonical_pose=True,
                                            compute_divergence=True, divergence_probe=probe)
    assert float(canonical.detach().abs().max()) == 0.0 and float(canonical_disp.detach().abs().max()) == 0.0


def _flat(tree, path=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, path + (name,))
        else:
            yield path + (name,), value


# ---- the composer's fine pass ----------------------------------------------------


def fine_scene(separate=True, use_fused_backbone=False):
    scene = fused_scene(use_fused_backbone=use_fused_backbone)
    return dataclasses.replace(scene, separate_fine=separate, object_models=tuple(
        dataclasses.replace(om, use_fine=True, positions_count_fine=fine)
        for om, fine in zip(scene.object_models, FINE)))


def composer_inputs():
    """Rays from (0, -6, 1) through the player's box at the origin and on
    to the ground slab below it."""
    rng = np.random.default_rng(7)
    origins = np.tile(np.asarray([0.0, -6.0, 1.0], np.float32), (2, 1))
    directions = np.stack([rng.uniform(-0.08, 0.08, (2, 6)), np.ones((2, 6)), rng.uniform(-0.3, 0.05, (2, 6))],
                          axis=-1).astype(np.float32)
    normals = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32), (2, 1))
    w2o = np.tile(np.eye(4, dtype=np.float32), (2, 2, 1, 1))
    style = rng.normal(size=(2, 2, 8)).astype(np.float32)
    deformation = rng.normal(size=(2, 2, 4)).astype(np.float32)
    in_scene = np.ones((2, 2), bool)
    return origins, directions, normals, w2o, style, deformation, in_scene


@pytest.mark.parametrize("separate", [False, True])
def test_composer_fine_pass_matches_jax(separate):
    scene = fine_scene(separate)
    inputs = composer_inputs()
    module = JaxComposer(scene)
    args = [jnp.asarray(a) for a in inputs]
    options = dict(perturb=True, step=jnp.asarray(30), compute_divergence=True)
    rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(("params", "sampling", "alpha_noise",
                                                                  "divergence"))}
    shapes = jax.eval_shape(lambda: module.init(rngs, *args, **options))
    variables = {kind: seeded_tree(shapes[kind], np.random.default_rng(8)) for kind in shapes}
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def run(variables):
        with recorded_draws(("uniform", "normal")) as draws:
            out = module.apply(variables, *args, **options, rngs=rngs, mutable=["batch_stats"])
        names[:] = [n for n, _ in draws]
        return out, [v for _, v in draws]

    (ref, mutated), values = jax.device_get(run(variables))
    draws = [(n, np.asarray(v)) for n, v in zip(names, values)]
    composer = SceneComposer(to_port(scene), device="cpu")
    fine_fields = [n for n, _ in composer.named_children() if n.startswith("object_model_fine_")]
    assert fine_fields == (["object_model_fine_0", "object_model_fine_1"] if separate else [])
    load_flax_tree(composer, variables["params"], variables["batch_stats"])
    composer.train()
    replay = Replay(draws)
    got = composer(*(t(a) for a in inputs), perturb=True, rng=replay, step=30, compute_divergence=True)
    assert not replay.draws
    # Per object: strata, divergence probe (the player), the coarse weights'
    # alpha noise, sample_pdf, the fine probe; then each pass's composition.
    assert replay.streams == (["sampling", "alpha_noise", "sampling"]
                              + ["sampling", "divergence", "alpha_noise", "sampling", "divergence"]
                              + ["alpha_noise"] * 6), replay.streams
    for pass_name in ("coarse", "fine"):
        for entry in ("object_0", "object_1", "global"):
            for name, value in ref[pass_name][entry].items():
                close(got[pass_name][entry][name], value, dict(rtol=1e-4, atol=1e-5),
                      err_msg=f"{pass_name} {entry} {name}")
    assert got["fine"]["global"]["weights"].shape[-1] == sum(FINE) + 4 + 8
    assert float(got["fine"]["object_1"]["integrated_divergence"].detach().abs().max()) > 0
    expected = SceneComposer(to_port(scene), device="cpu")
    load_flax_tree(expected, variables["params"], mutated["batch_stats"])
    for name, buffer in composer.named_buffers():
        close(buffer, expected.get_buffer(name).numpy(), err_msg=name)


# ---- camera offsets and the weight bridge ---------------------------------------


def test_camera_offsets_match_jax():
    rng = np.random.default_rng(9)
    table = rng.normal(size=(CAMERA_MEMORY, 2, 7)).astype(np.float32)
    indexes = np.asarray([[0, 3], [-2, 9]], np.int32)  # clipped into the table
    module = JaxCameraStorage(CAMERA_MEMORY, 2)
    storage = CameraParametersStorage(CAMERA_MEMORY, 2)
    with torch.no_grad():
        storage.storage.copy_(t(table))
    for train in (True, False):
        ref = module.apply({"params": {"storage": jnp.asarray(table)}}, jnp.asarray(indexes), train)
        got = storage(t(indexes), train)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(r))
    assert float(storage(t(indexes), False)[2].abs().max()) == 0.0


def options_model_kwargs():
    return dict(enable_camera_offsets=True, camera_memory_size=CAMERA_MEMORY, training_cameras_count=1)


def test_weight_bridge_loads_fine_fields_and_camera_offsets():
    """Strict both ways: a model with camera offsets needs the table, and a
    tree's table is reported unread where the model has none."""
    scene = path_scene("direct")
    variables = initial_variables("direct")
    assert {"object_model_fine_0", "object_model_fine_1"} <= set(variables["params"]["composer"])
    port = EnvironmentModel(to_port(scene), device="cpu", **options_model_kwargs())
    assert load_environment_model(port, variables) == []
    np.testing.assert_array_equal(port.camera_offsets.storage.detach().numpy(),
                                  variables["params"]["camera_offsets"]["storage"])
    leaf = variables["params"]["composer"]["object_model_fine_1"]["ray_bender"]["output_head"]["kernel"]
    np.testing.assert_array_equal(port.composer.object_model_fine_1.ray_bender.output_head.weight.detach().numpy(),
                                  leaf.T)
    without = {"params": {k: v for k, v in variables["params"].items() if k != "camera_offsets"},
               "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="camera_offsets"):
        load_environment_model(EnvironmentModel(to_port(scene), device="cpu", **options_model_kwargs()), without)
    assert load_environment_model(EnvironmentModel(to_port(scene), device="cpu"), variables) == ["camera_offsets"]


# ---- whole phase-2 steps -------------------------------------------------------------


def options_arrays():
    arrays = batch_arrays()
    arrays["global_frame_indexes"] = np.asarray([[0, 1], [4, 9]], np.int32)  # 9: clipped to the last row
    return arrays


def options_config(module, path, **changes):
    changes.setdefault("camera_parameters_learning_rate", CAMERA_RATE)
    weights = dict(WEIGHTS)
    if path == "decoder":
        weights.pop("ray_object_distance")
        return module.SynthesisTrainingConfig(
            learning_rate=LEARNING_RATE, samples_per_image=0, patch_size=8, patch_strides=STRIDES, perturb=True,
            shuffle_style=True, max_steps=4, decode_patches=True, frozen_autoencoder_steps=0,
            loss_weights=module.LossWeights(**weights), **changes)
    return module.SynthesisTrainingConfig(
        learning_rate=LEARNING_RATE, samples_per_image=12, perturb=True, shuffle_style=True, max_steps=4,
        loss_weights=module.LossWeights(**weights), **changes)


def path_scene(path):
    if path == "decoder":
        scene = decoder_scene()
        return dataclasses.replace(scene, object_models=tuple(
            dataclasses.replace(om, use_fine=True, positions_count_fine=fine)
            for om, fine in zip(scene.object_models, FINE)))
    return fine_scene(separate=True)


def path_arrays(path):
    if path == "decoder":
        arrays = decoder_arrays()
        arrays["global_frame_indexes"] = np.asarray([[0, 1], [4, 9]], np.int32)
        return arrays
    return options_arrays()


def initial_variables(path):
    """Seeded flax variables of the path's model (a copy), the camera table
    small (an offset of 1e-3 is a focal 1 pixel longer)."""
    return copy.deepcopy(_initial_variables(path))


@functools.lru_cache(maxsize=None)
def _initial_variables(path):
    scene, arrays = path_scene(path), path_arrays(path)
    cfg = options_config(jax_trainer, path)
    model = JaxEnvironmentModel(scene, **options_model_kwargs())
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    init = functools.partial(model.init, samples_per_image=cfg.samples_per_image, patch_size=cfg.patch_size,
                             patch_strides=list(cfg.patch_strides) or None, decode_patches=cfg.decode_patches)
    shapes = jax.eval_shape(lambda k: init({**jax_trainer.split_rngs(k), "params": k},
                                           *batch.environment_model_args()), jax.random.PRNGKey(0))
    variables = {kind: seeded_tree(shapes[kind], np.random.default_rng(11)) for kind in ("params", "batch_stats")}
    storage = variables["params"]["camera_offsets"]["storage"]
    variables["params"]["camera_offsets"]["storage"] = (
        np.random.default_rng(12).normal(size=storage.shape) * 1e-3).astype(np.float32)
    return variables


def port_model(path, tree):
    model = EnvironmentModel(to_port(path_scene(path)), device="cpu", **options_model_kwargs())
    assert load_environment_model(model, tree) == []
    return model


def port_step(path, remat):
    """One port step from the seeded variables, its draws recorded:
    ((loss, metrics, grads, state after), draws)."""
    model = port_model(path, initial_variables(path))
    trainer = trainer_synthesis.SynthesisTrainer(model, options_config(trainer_synthesis, path, remat=remat))
    assert {g["name"] for g in trainer.optimizer.optimizer.param_groups} >= {"camera_offsets"}
    trainer.optimizer.step_count = FIRST_STEP
    batch = Batch(**{k: t(v) for k, v in path_arrays(path).items()})
    model.train()
    trainer.optimizer.zero_grad()
    streams = RecordingStreams(13)
    loss, metrics, _ = trainer.compute_losses(batch, streams, trainer.step)
    loss.backward()
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p) for n, p in model.named_parameters()}
    trainer.optimizer.step()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()}), streams.draws


@functools.lru_cache(maxsize=None)
def port_run(path, remat):
    return port_step(path, remat)


@functools.lru_cache(maxsize=None)
def jax_run(path, remat):
    """JAX's step on the port's draws (those of the port's step without
    remat): (loss, metrics, grads, variables after, draws)."""
    scene, arrays = path_scene(path), path_arrays(path)
    cfg = options_config(jax_trainer, path, remat=remat)
    model = JaxEnvironmentModel(scene, **options_model_kwargs())
    trainer = jax_trainer.SynthesisTrainer(model, cfg)
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    initial = initial_variables(path)
    groups = {"camera_offsets": cfg.camera_parameters_learning_rate}
    freeze = None
    if cfg.decode_patches:
        groups["autoencoder"] = cfg.autoencoder_learning_rate
        freeze = {"autoencoder": cfg.frozen_autoencoder_steps}
    tx = make_optimizer(cfg.learning_rate, cfg.lr_gamma, cfg.lr_decay_iterations, cfg.weight_decay,
                        group_learning_rates=groups, group_freeze_steps=freeze)
    state = create_train_state(initial["params"], initial["batch_stats"], tx).replace(
        step=jnp.asarray(FIRST_STEP, jnp.int32))
    draws = port_run(path, False)[1]

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def step(state):
        with draws_into_jax(draws) as pending:
            def loss_fn(p):
                return trainer.compute_losses(p, state.batch_stats, batch, jax.random.PRNGKey(0), state.step)

            (loss, (metrics, new_stats, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
            assert not pending, f"{len(pending)} draws left over"
        new_state = state.apply_gradients(grads).replace(batch_stats=new_stats)
        return loss, metrics, grads, {"params": new_state.params, "batch_stats": new_state.batch_stats}

    return initial, jax.device_get(step(state)) + (draws,)


EXPECTED_STREAMS = {
    # style shuffle per object, the weighted ray picks, then the composer.
    "direct": ["style_shuffle"] * 2 + ["ray_sampling"],
    # style shuffle per object, the patch centre, then the composer.
    "decoder": ["style_shuffle"] * 2 + ["ray_sampling"],
}
COMPOSER_STREAMS = (["sampling", "alpha_noise", "sampling"]
                    + ["sampling", "divergence", "alpha_noise", "sampling", "divergence"] + ["alpha_noise"] * 6)


def test_options_step_matches_jax():
    """The direct-ray step with every option on against JAX's, `remat` on
    both sides, the port's draws replayed."""
    check_options_step("direct", remat=True)


def check_options_step(path, remat):
    """The port's step against JAX's (module docstring's bounds)."""
    initial, (jloss, jmetrics, jgrads, jafter, draws) = jax_run(path, remat)
    assert [stream for _, stream, _ in draws] == EXPECTED_STREAMS[path] + COMPOSER_STREAMS
    got = port_run(path, remat)[0]
    assert {f"fine_{k}" for k in ("reconstruction_loss", "divergence_loss")} <= set(got[1])
    assert float(got[1]["fine_divergence_loss"]) > 0 and float(got[1]["coarse_divergence_loss"]) > 0
    loss, metrics, grads, state = got
    assert set(metrics) == set(jmetrics)
    for name, value in list(metrics.items()) + [("loss", loss)]:
        np.testing.assert_allclose(value.numpy(), np.asarray(jmetrics[name]), rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=name)
    ref_grads = port_model(path, {"params": jgrads, "batch_stats": initial["batch_stats"]}).state_dict()
    atol = {name: 1e4 * (ENCODER_RTOL[path] if name.startswith("object_encoder_") else GRADIENT_RTOL) * tol
            for name, tol in gradient_tolerances(ref_grads, list(grads)).items()}
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(), rtol=0, atol=atol[name], err_msg=name)
    ref_state, start = port_model(path, jafter).state_dict(), port_model(path, initial).state_dict()
    for name, value in state.items():
        ref_value = ref_state[name]
        if name in grads:
            diff, grad = (value - ref_value).abs(), ref_grads[name].abs()
            clear = grad > max(1e-3 * grad.max().item(), 2 * atol[name])
            assert bool((diff[clear] <= 1e-6 + 1e-5 * ref_value[clear].abs()).all()), name
            assert bool((diff <= 2 * max(LEARNING_RATE, CAMERA_RATE) + 1e-6).all()), name
        else:
            np.testing.assert_allclose(value.numpy(), ref_value.numpy(), rtol=1e-5, atol=STATS_TOL, err_msg=name)
    assert float(grads["camera_offsets.storage"].abs().max()) > 0
    fine = [n for n in grads if "object_model_fine_" in n]
    if path == "direct":
        assert fine and all(n.replace("object_model_fine_", "object_model_") in grads for n in fine)
    else:
        assert not fine  # shared fine fields
    # The camera table moves at its own rate: Adam's first step is about
    # CAMERA_RATE a clear element.
    moved = (state["camera_offsets.storage"] - start["camera_offsets.storage"]).abs().max()
    assert 0.5 * CAMERA_RATE < float(moved) < 2 * CAMERA_RATE + 1e-6


def test_remat_step_matches_the_plain_step():
    check_remat_step("direct")


def check_remat_step(path):
    """The same step with and without `remat` in the port: same draws,
    same loss, gradients and running statistics (updated once)."""
    (loss, metrics, grads, state), draws = port_run(path, True)
    (ref_loss, ref_metrics, ref_grads, ref_state), ref_draws = port_run(path, False)
    assert [(k, s, v.shape) for k, s, v in draws] == [(k, s, v.shape) for k, s, v in ref_draws]
    assert all(np.array_equal(a[2], b[2]) for a, b in zip(draws, ref_draws))
    np.testing.assert_allclose(loss.numpy(), ref_loss.numpy(), rtol=1e-6)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.numpy(), ref_metrics[name].numpy(), rtol=1e-6, atol=1e-9, err_msg=name)
    for name, grad in grads.items():
        scale = ref_grads[name].abs().max().item()
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(), rtol=0, atol=1e-6 * scale + 1e-12,
                                   err_msg=name)
    for name, value in state.items():
        np.testing.assert_allclose(value.numpy(), ref_state[name].numpy(), rtol=1e-6, atol=1e-9, err_msg=name)


def test_remat_on_the_fused_backbone_path_matches_the_plain_step():
    """The fused backbone's autograd Function re-runs inside the NeRF's
    rematerialized region (on the card: one more B2 launch an object a
    pass); its gradients and running statistics do not move."""
    scene = to_port(fine_scene(separate=False, use_fused_backbone=True))
    outputs = []
    for remat in (False, True):
        model = EnvironmentModel(scene, device="cpu", seed=3, **options_model_kwargs())
        trainer = trainer_synthesis.SynthesisTrainer(model, options_config(trainer_synthesis, "direct", remat=remat))
        model.train()
        loss, _, _ = trainer.compute_losses(Batch(**{k: t(v) for k, v in options_arrays().items()}),
                                            RngStreams(14, "cpu"), 2)
        loss.backward()
        outputs.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                        {k: v for k, v in model.state_dict().items()}))
    (loss, grads, state), (ref_loss, ref_grads, ref_state) = outputs
    np.testing.assert_allclose(loss.numpy(), ref_loss.numpy(), rtol=1e-6)
    for name, grad in grads.items():
        scale = ref_grads[name].abs().max().item()
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(), rtol=0, atol=1e-6 * scale + 1e-12,
                                   err_msg=name)
    for name, value in state.items():
        np.testing.assert_allclose(value.numpy(), ref_state[name].numpy(), rtol=1e-6, atol=1e-9, err_msg=name)


def test_camera_offset_group_is_frozen_at_rate_zero():
    """The camera table's rate group exists only when the model has the
    table; at rate 0.0 a step leaves it as it was while the rest moves."""
    scene = to_port(fused_scene(use_fused_backbone=False))
    plain = trainer_synthesis.SynthesisTrainer(EnvironmentModel(scene, device="cpu"),
                                               options_config(trainer_synthesis, "direct"))
    assert "camera_offsets" not in {g["name"] for g in plain.optimizer.optimizer.param_groups}
    model = EnvironmentModel(scene, device="cpu", **options_model_kwargs())
    with torch.no_grad():
        model.camera_offsets.storage.normal_(generator=torch.Generator().manual_seed(0)).mul_(1e-3)
    before = model.camera_offsets.storage.detach().clone()
    trainer = trainer_synthesis.SynthesisTrainer(model, options_config(
        trainer_synthesis, "direct", camera_parameters_learning_rate=0.0))
    encoder_before = model.object_encoder_1.style_head.weight.detach().clone()
    trainer.train_step(Batch(**{k: t(v) for k, v in options_arrays().items()}), RngStreams(15, "cpu"))
    assert float(model.camera_offsets.storage.grad.abs().max()) > 0
    assert torch.equal(model.camera_offsets.storage.detach(), before)
    assert not torch.equal(model.object_encoder_1.style_head.weight.detach(), encoder_before)
