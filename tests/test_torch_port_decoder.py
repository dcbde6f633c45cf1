"""The published phase-2 decoder path, the port against the JAX package on
the CPU:

- `_align_start` (floor-mod on negative starts) and
  `sample_rays_strided_patch` with replayed centre draws, centres clipped at
  each image edge: exactly;
- `split_strided_samples`, `samples_to_patch` and
  `crop_region_from_patch_positions`: exactly;
- the decoder in train mode (batch statistics, running statistics updated
  at flax's momentum) with its input and parameter gradients: f32 at 1e-5;
  bf16 at 3e-2 absolute on the [0, 1] output and 3e-3 in its mean (bf16
  keeps 8 bits, 4e-3 of a value, and the decoder chains ~10 roundings),
  its gradients and running statistics within twice JAX's own bf16 error
  against its f32 decode;
- `EnvironmentModel.decode_rendered_patches` at 1e-5;
- the max pool's gradient on tied windows: exactly (the first maximum in
  row-major order takes it, as the JAX package's pool);
- two whole phase-2 steps of a tiny tennis-shaped decoder scene (patch 8,
  strides (4, 8), 48x64 frames, the v8 autoencoder at bottleneck 16) with
  `frozen_autoencoder_steps` 1, so that the first step holds the
  autoencoder at rate 0 while Adam's moments advance and the second moves
  it; the patch centre drawn by JAX and replayed (perturbation and the
  style shuffle off, as tests/test_torch_port_train.py has them; the
  Minecraft step of test_torch_port_minecraft_train.py runs them); a
  perceptual weight of 0.1 set on both sides, which neither applies. Each
  step starts from JAX's state before it. The parameters and running
  statistics after each step are held as test_torch_port_train.py holds
  them; the loss and metrics at 3e-5 and every gradient at 2e-3 of its
  tensor's largest, from the f32 error of this path measured against
  float64 (GRADIENT_RTOL below).

JAX variables come from `jax.eval_shape` of the inits plus seeded values
(tests/test_torch_port_phase3.py's `seeded_tree`), and the JAX steps are
jitted with XLA's backend optimization off, to keep the file cheap.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.data.batching import Batch as JaxBatch
from playableenvironments_tpu.models.autoencoder import MultiresAutoencoder as JaxAutoencoder
from playableenvironments_tpu.ops.pool import max_pool_2x2
from playableenvironments_tpu.render import sampling as jsampling
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.train import trainer_synthesis as jax_trainer
from playableenvironments_tpu.train.state import create_train_state, make_optimizer
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.compat.from_flax import load_autoencoder, load_environment_model
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.models.autoencoder import MultiresAutoencoder
from playableenvironments_tpu_torch.render import sampling
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.train import trainer_synthesis
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_phase3 import gradient_tolerances, seeded_tree
from test_torch_port_train import fused_scene, to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

# Gradients through the decoder path: against the same step in float64 (the
# port with every dtype raised), the port's f32 gradients are off by up to
# 6.2e-4 of a tensor's largest and the JAX package's by up to 4.0e-4, so
# each is held to 2e-3 of it (plus 2e-5 of its model's largest, for the
# biases that feed a batch norm); the loss, 1.6e-6 and 8.3e-6 relative from
# float64, to 3e-5.
GRADIENT_RTOL = 2e-3
METRIC_RTOL = 3e-5
# Running statistics after a step: 1e-5 relative, and 2e-5 absolute for the
# AdaIN means of a player's in-box samples (a patch's rays graze the
# player's box, whose faces decide membership at the last bit; measured
# 7.3e-6).
STATS_ATOL = 2e-5
NO_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
AE = dict(bottleneck_features=16, bottleneck_blocks=1, downsampling_layers_count=(2, 1))
PATCH, STRIDES = 8, (4, 8)
B, T, C, H, W = 2, 2, 1, 48, 64
LEARNING_RATE, AE_LEARNING_RATE = 5e-4, 1e-4
WEIGHTS = dict(reconstruction=1.0, perceptual=0.1, ray_object_distance=0.1, bounding_box=0.1,
               displacements_magnitude=0.1, opacity=0.01, attention=0.01, sharpness=0.01)


def t(x):
    return torch.from_numpy(np.array(x))


def test_align_start_matches_jax():
    starts = np.arange(-20, 21, dtype=np.int32)
    for stride in (1, 2, 4, 8):
        ref = jsampling._align_start(jnp.asarray(starts), stride)
        np.testing.assert_array_equal(sampling._align_start(t(starts), stride).numpy(), np.asarray(ref))


@pytest.mark.parametrize("patch,strides", [(4, (2, 4)), (PATCH, STRIDES)])
def test_strided_patch_sampling_matches_jax(patch, strides):
    """One box per image at each corner and edge (so the drawn centre is
    clipped there) and one in the middle; the same centre draws."""
    h, w = 24 * strides[-1] // 4, 40 * strides[-1] // 4
    boxes = np.asarray([[0.0, 0.0, 0.05, 0.05], [0.95, 0.95, 1.0, 1.0], [0.0, 0.4, 0.05, 0.6],
                        [0.95, 0.4, 1.0, 0.6], [0.4, 0.0, 0.6, 0.05], [0.4, 0.95, 0.6, 1.0],
                        [0.45, 0.45, 0.55, 0.55], [0.0, 0.95, 0.05, 1.0]], np.float32)[:, None]
    rng = np.random.default_rng(0)
    directions = rng.normal(size=(8, h, w, 3)).astype(np.float32)
    observations = rng.random((8, h, w, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    refs = jsampling.sample_rays_strided_patch(key, jnp.asarray(directions), jnp.asarray(observations), patch,
                                               list(strides), jnp.asarray(boxes), (1.0,))
    u = jax.random.uniform(key, (8, 1), dtype=jnp.float32)
    gots = sampling.sample_rays_strided_patch(t(directions), t(observations), patch, strides, t(boxes), (1.0,), t(u))
    for got, ref in zip(gots, refs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rows = gots[2][:, 0, 0].numpy() * h
    assert rows.min() < strides[-1] and rows.max() > h - 2 * strides[-1] * (patch // 2)  # both edges reached

    finest = sampling.split_strided_samples(gots[2], patch, strides)[0]
    ref_finest = jsampling.split_strided_samples(refs[2], patch, list(strides))[0]
    np.testing.assert_array_equal(finest.numpy(), np.asarray(ref_finest))
    crops = sampling.crop_region_from_patch_positions(t(observations), finest, patch, strides[0])
    ref_crops = jsampling.crop_region_from_patch_positions(jnp.asarray(observations), ref_finest, patch, strides[0])
    assert crops.shape == (8, patch * strides[0], patch * strides[0], 3)
    np.testing.assert_array_equal(crops.numpy(), np.asarray(ref_crops))
    for got, ref in zip(sampling.split_strided_samples(gots[1], patch, strides),
                        jsampling.split_strided_samples(refs[1], patch, list(strides))):
        np.testing.assert_array_equal(sampling.samples_to_patch(got).numpy(),
                                      np.asarray(jsampling.samples_to_patch(ref)))


def test_max_pool_gradient_on_tied_windows_matches_jax():
    """Windows of ReLU zeros and of equal maxima in every position."""
    rng = np.random.default_rng(1)
    x = np.maximum(rng.normal(size=(2, 8, 8, 3)), 0).astype(np.float32)
    x[0, :2, :2, 0] = 0.5
    x[0, 2, 2:4, 1] = 0.7
    x[0, 2:4, 4, 2] = 0.9
    x[1, 4:6, 4:6] = 0.0
    g = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    _, vjp = jax.vjp(max_pool_2x2, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    F.max_pool2d(xt, 2).backward(t(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


def autoencoder_variables(cfg, seed, shape=(1, 32, 32, 3)):
    """Seeded values on jax.eval_shape's tree of a whole MultiresAutoencoder."""
    ae = JaxAutoencoder(cfg)
    shapes = jax.eval_shape(lambda k: ae.init(k, jnp.zeros(shape), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return {kind: seeded_tree(shapes[kind], rng) for kind in ("params", "batch_stats")}


def jax_decoder_train(dtype, variables, levels, cotangent):
    """JAX's train-mode decode in `dtype`: (output, running statistics,
    parameter gradients, level gradients) of sum(output * cotangent)."""
    ae = JaxAutoencoder(jax_config.AutoencoderConfig(compute_dtype=dtype, **AE))

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def run(params, levels):
        def loss(params, levels):
            out, mutated = ae.apply({"params": params, "batch_stats": variables["batch_stats"]}, levels, True,
                                    method=JaxAutoencoder.decode, mutable=["batch_stats"])
            return jnp.sum(out * cotangent), (out, mutated["batch_stats"])

        return jax.grad(loss, argnums=(0, 1), has_aux=True)(params, levels)

    (grads, level_grads), (out, stats) = jax.device_get(run(variables["params"], [jnp.asarray(v) for v in levels]))
    return out, stats, grads, level_grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_train_mode_matches_jax(dtype):
    """f32 at 1e-5. bf16 against JAX's bf16: the output within 3e-2 and
    3e-3 in the mean; the level gradients and running statistics within
    twice (plus 1e-3 of their scale) JAX's own bf16 error against its f32
    decode, which the cancellations of the batch norms' backward make ~10%."""
    variables = autoencoder_variables(jax_config.AutoencoderConfig(**AE), seed=2)
    rng = np.random.default_rng(3)
    levels = [rng.normal(size=(4, 8, 8, 8)).astype(np.float32), rng.normal(size=(4, 4, 4, 16)).astype(np.float32)]
    cotangent = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    ref, stats, grads, level_grads = jax_decoder_train(dtype, variables, levels, cotangent)
    model = MultiresAutoencoder(port_config.AutoencoderConfig(compute_dtype=dtype, **AE), device="cpu")
    load_autoencoder(model, variables)
    inputs = [t(v).requires_grad_(True) for v in levels]
    out = model.decode(inputs, train=True)
    (out * t(cotangent)).sum().backward()
    expected = MultiresAutoencoder(port_config.AutoencoderConfig(**AE), device="cpu")
    load_autoencoder(expected, {"params": grads, "batch_stats": stats})
    buffers = [(name, buffer.numpy(), expected.decoder.get_buffer(name).numpy())
               for name, buffer in model.decoder.named_buffers()]
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
        for got, want in zip(inputs, level_grads):
            np.testing.assert_allclose(got.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        # 1e-4 of each tensor's largest, plus 1e-6 of the decoder's (a bias
        # that feeds a batch norm has f32 noise for a gradient).
        scale = max(p.abs().max().item() for p in expected.decoder.parameters())
        for name, param in model.decoder.named_parameters():
            want = expected.decoder.get_parameter(name).detach()
            np.testing.assert_allclose(param.grad.numpy(), want.numpy(), rtol=0,
                                       atol=1e-4 * want.abs().max().item() + 1e-6 * scale, err_msg=name)
        for name, got, want in buffers:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
        return
    diff = np.abs(out.detach().numpy() - ref)
    assert diff.max() <= 3e-2 and diff.mean() <= 3e-3, (diff.max(), diff.mean())
    ref32, stats32, _, level_grads32 = jax_decoder_train("float32", variables, levels, cotangent)
    for got, want, want32 in zip(inputs, level_grads, level_grads32):
        own = np.abs(want - want32).mean()
        assert np.abs(got.grad.numpy() - want).mean() <= 2 * own + 1e-3 * np.abs(want32).mean()
    expected32 = MultiresAutoencoder(port_config.AutoencoderConfig(**AE), device="cpu")
    load_autoencoder(expected32, {"params": variables["params"], "batch_stats": stats32})
    for name, got, want in buffers:
        want32 = expected32.decoder.get_buffer(name).numpy()
        own = np.abs(want - want32).max()
        assert np.abs(got - want).max() <= 2 * own + 1e-3 * np.abs(want32).max(), name


# ---- the decoder scene and its whole steps ----------------------------------


def decoder_scene():
    """test_torch_port_train.py's tiny scene on the plain backbone, as
    tennis.yaml's decoder path has it: no activation, NeRF outputs the sum
    of the latent levels' widths (8 + 16), the v8 autoencoder."""
    scene = fused_scene(use_fused_backbone=False)
    return dataclasses.replace(
        scene, apply_activation=False, autoencoder=jax_config.AutoencoderConfig(**AE),
        object_models=tuple(dataclasses.replace(om, nerf=dataclasses.replace(om.nerf, output_features=24))
                            for om in scene.object_models),
    )


def batch_arrays(seed=0):
    rng = np.random.default_rng(seed)
    rotations = np.zeros((B, T, C, 3), np.float32)
    rotations[..., 0] = -0.6
    translations = np.zeros((B, T, C, 3), np.float32)
    translations[..., 1], translations[..., 2] = 8.0, 10.0
    boxes = np.broadcast_to(np.asarray([0.4, 0.3, 0.6, 0.7], np.float32), (B, T, C, 1, 4)).copy()
    boxes += rng.uniform(-0.05, 0.05, boxes.shape).astype(np.float32)
    validity = np.ones((B, T, C, 1), bool)
    validity[1, 1] = False
    frames = np.zeros((B, T), np.int32)
    return dict(
        observations=rng.random((B, T, C, H, W, 3), np.float32),
        camera_rotations=rotations, camera_translations=translations,
        focals=np.full((B, T, C), 80.0, np.float32), bounding_boxes=boxes,
        bounding_boxes_validity=validity, global_frame_indexes=frames,
        video_frame_indexes=frames, video_indexes=np.zeros((B,), np.int32),
    )


def training_config(module, **changes):
    return module.SynthesisTrainingConfig(
        learning_rate=LEARNING_RATE, samples_per_image=0, patch_size=PATCH, patch_strides=STRIDES,
        perturb=False, shuffle_style=False, max_steps=4, decode_patches=True,
        autoencoder_learning_rate=AE_LEARNING_RATE, frozen_autoencoder_steps=1,
        loss_weights=module.LossWeights(**WEIGHTS), **changes,
    )


def jax_synthesis_steps(jscene, cfg, arrays, keys, seed, multiplier=1.0):
    """JAX SynthesisTrainer steps from seeded variables (on eval_shape's
    tree of the model's init), each with its draws recorded:
    (initial variables, [(loss, metrics, grads, variables after, draws)])."""
    model = JaxEnvironmentModel(jscene, focal_length_multiplier=multiplier)
    trainer = jax_trainer.SynthesisTrainer(model, cfg)
    batch = JaxBatch(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    init = functools.partial(model.init, samples_per_image=cfg.samples_per_image, patch_size=cfg.patch_size,
                             patch_strides=list(cfg.patch_strides), decode_patches=cfg.decode_patches)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: init({**jax_trainer.split_rngs(k), "params": k},
                                           *batch.environment_model_args()), key)
    rng = np.random.default_rng(seed)
    initial = {kind: seeded_tree(shapes[kind], rng) for kind in ("params", "batch_stats")}
    tx = make_optimizer(cfg.learning_rate, cfg.lr_gamma, cfg.lr_decay_iterations, cfg.weight_decay,
                        group_learning_rates={"autoencoder": cfg.autoencoder_learning_rate},
                        group_freeze_steps={"autoencoder": cfg.frozen_autoencoder_steps})
    state = create_train_state(initial["params"], initial["batch_stats"], tx)
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def step(state, key):
        with recorded_draws() as draws:
            def loss_fn(p):
                return trainer.compute_losses(p, state.batch_stats, batch, key, state.step)

            (loss, (metrics, new_stats, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        names[:] = [name for name, _ in draws]
        new_state = state.apply_gradients(grads).replace(batch_stats=new_stats)
        return new_state, loss, metrics, grads, [v for _, v in draws]

    out = []
    for key in keys:
        state, loss, metrics, grads, values = step(state, key)
        after = {"params": state.params, "batch_stats": state.batch_stats}
        loss, metrics, grads, after, values = jax.device_get((loss, metrics, grads, after, values))
        out.append((loss, metrics, grads, after, [(n, np.asarray(v)) for n, v in zip(names, values)]))
    return initial, out


def port_synthesis_steps(model, trainer, batch, draws_per_step, starts=()):
    """The port's steps on the same draws: [(loss, metrics, grads, state
    after)]. Step i > 0 starts from the flax variables `starts[i - 1]` (JAX's
    state after the step before, loaded in place; Adam's moments stay the
    port's), so that each step is held alone."""
    out = []
    for i, draws in enumerate(draws_per_step):
        if i:
            assert load_environment_model(model, starts[i - 1]) == []
        model.train()
        trainer.optimizer.zero_grad()
        replay = Replay(draws)
        loss, metrics, _ = trainer.compute_losses(batch, replay, trainer.step)
        assert not replay.draws
        loss.backward()
        grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
        trainer.optimizer.step()
        out.append((loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads,
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out


def check_synthesis_step(port_model, got, ref, before, learning_rate, moment_slack=0.0,
                         gradient_rtol=GRADIENT_RTOL, metric_rtol=METRIC_RTOL, stats_atol=STATS_ATOL):
    """One step of the port against JAX's (module docstring's tolerances).
    `port_model(tree)` loads a flax tree into a fresh port model. After a
    step whose Adam moments carry the port's own earlier gradients, the
    parameters whose gradient is clear get `moment_slack` more."""
    loss, metrics, grads, state = got
    jloss, jmetrics, jgrads, jafter, _ = ref
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=metric_rtol, atol=1e-7)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jmetrics[name]), rtol=metric_rtol, atol=1e-7,
                                   err_msg=name)
    params = list(grads)
    ref_grads = port_model({"params": jgrads, "batch_stats": before["batch_stats"]}).state_dict()
    atol = {name: gradient_rtol * 1e4 * tol for name, tol in gradient_tolerances(ref_grads, params).items()}
    for name in params:
        np.testing.assert_allclose(grads[name].numpy(), ref_grads[name].numpy(), rtol=0, atol=atol[name],
                                   err_msg=name)
    ref_state = port_model(jafter).state_dict()
    start = port_model(before).state_dict()
    for name, value in state.items():
        ref_value = ref_state[name]
        if name in grads:
            diff = (value - ref_value).abs()
            grad = ref_grads[name].abs()
            clear = grad > max(1e-3 * grad.max().item(), 2 * atol[name])
            assert bool((diff[clear] <= 1e-6 + 1e-5 * ref_value[clear].abs() + moment_slack).all()), name
            assert bool((diff <= 2 * learning_rate + 1e-6).all()), name
        else:
            np.testing.assert_allclose(value.numpy(), ref_value.numpy(), rtol=1e-5, atol=stats_atol, err_msg=name)
    return start, ref_state


@functools.lru_cache(maxsize=None)
def jax_run():
    return jax_synthesis_steps(decoder_scene(), training_config(jax_trainer), batch_arrays(),
                               [jax.random.PRNGKey(10), jax.random.PRNGKey(11)], seed=1)


def tennis_port_model(tree):
    model = EnvironmentModel(to_port(decoder_scene()), device="cpu")
    assert load_environment_model(model, tree) == []
    return model


@pytest.fixture(scope="module")
def port_run():
    initial, steps = jax_run()
    model = tennis_port_model(initial)
    trainer = trainer_synthesis.SynthesisTrainer(model, training_config(trainer_synthesis))
    batch = Batch(**{k: torch.from_numpy(v) for k, v in batch_arrays().items()})
    return port_synthesis_steps(model, trainer, batch, [s[-1] for s in steps], [s[3] for s in steps])


def test_decoder_path_draws_and_metrics():
    """The patch centre is one draw per image from "ray_sampling"; the
    decoder path has no ray-object distance term, and the perceptual
    weight adds nothing: the loss is the sum of the weighted terms."""
    _, steps = jax_run()
    kinds = [name for name, _ in steps[0][-1]]
    assert kinds == ["uniform"], kinds
    assert steps[0][-1][0][1].shape == (B, T, C, 1)
    metrics = steps[0][1]
    assert "coarse_ray_object_distance_loss" not in metrics and "perceptual_loss" not in metrics
    w = WEIGHTS
    expected = (w["reconstruction"] * metrics["coarse_reconstruction_loss"]
                + w["displacements_magnitude"] * metrics["coarse_displacements_magnitude_loss"]
                + w["opacity"] * metrics["coarse_object_1_opacity_loss"]
                + w["attention"] * metrics["object_1_attention_loss"]
                + w["bounding_box"] * metrics["bounding_box_loss"])
    np.testing.assert_allclose(metrics["loss"], expected, rtol=1e-5)  # sharpness annealed to 0 at step 0


@pytest.mark.parametrize("step", [0, 1])
def test_decoder_step_matches_jax(port_run, step):
    """Step 0 with the autoencoder frozen, step 1 with it at its rate."""
    initial, steps = jax_run()
    before = initial if step == 0 else steps[0][3]
    # Step 1's moments hold the port's step-0 gradients (2e-3 of their
    # largest from JAX's): its clear updates agree to 2e-2 of the rate
    # (measured 6e-3).
    start, _ = check_synthesis_step(tennis_port_model, port_run[step], steps[step], before, LEARNING_RATE,
                                    moment_slack=2e-2 * LEARNING_RATE * step)
    state, grads = port_run[step][3], port_run[step][2]
    decoder = [n for n in grads if n.startswith("autoencoder.decoder.")]
    encoder = [n for n in grads if n.startswith("autoencoder.encoder.")]
    assert decoder and encoder and all(float(grads[n].abs().max()) == 0 for n in encoder)
    assert all(torch.equal(state[n], start[n]) for n in encoder)
    moved = [n for n in decoder if not torch.equal(state[n], start[n])]
    assert (moved == []) if step == 0 else len(moved) == len(decoder), moved
    stats = [n for n in state if n.startswith("autoencoder.decoder.") and n.endswith("running_mean")]
    assert stats and not any(torch.equal(state[n], start[n]) for n in stats)
    composer = [n for n in grads if n.startswith("composer.")]
    assert any(not torch.equal(state[n], start[n]) for n in composer)


def test_decode_rendered_patches_matches_jax():
    scene = decoder_scene()
    variables = autoencoder_variables(scene.autoencoder, seed=4)
    rng = np.random.default_rng(5)
    features = rng.normal(size=(B, T, C, 80, 24)).astype(np.float32)
    jmodel = JaxEnvironmentModel(scene)

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def decode(features):
        results = {"coarse": {"global": {"integrated_features": features}}}
        return jmodel.apply({kind: {"autoencoder": variables[kind]} for kind in variables}, results, PATCH, True,
                            method=JaxEnvironmentModel.decode_rendered_patches, mutable=["batch_stats"])

    ref, mutated = jax.device_get(decode(jnp.asarray(features)))
    model = EnvironmentModel(to_port(scene), device="cpu")
    load_autoencoder(model.autoencoder, variables)
    got = model.decode_rendered_patches({"coarse": {"global": {"integrated_features": t(features)}}}, PATCH)
    ref, got = ref["coarse"]["global"], got["coarse"]["global"]
    assert got["reconstructed_observations"].shape == (B, T, C, 32, 32, 3)
    np.testing.assert_allclose(got["reconstructed_observations"].detach().numpy(), ref["reconstructed_observations"],
                               rtol=1e-5, atol=1e-5)
    for g, r in zip(got["splitted_integrated_features"], ref["splitted_integrated_features"]):
        np.testing.assert_array_equal(g.numpy(), r)
    expected = EnvironmentModel(to_port(scene), device="cpu")
    load_autoencoder(expected.autoencoder, {"params": variables["params"],
                                            "batch_stats": mutated["batch_stats"]["autoencoder"]})
    for name, buffer in model.autoencoder.decoder.named_buffers():
        np.testing.assert_allclose(buffer.numpy(), expected.autoencoder.decoder.get_buffer(name).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
