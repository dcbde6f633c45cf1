"""The port's phase-2 train step against the JAX package, on the tiny
tennis-shaped scene of tests/test_environment_model.py (a static background
and a bent player) with `use_fused_backbone` set, so that the JAX side runs
the B2/B3 Pallas kernels in interpret mode and the port its fused-backbone
autograd Function (plain versions on the CPU).

One optimizer step, taken at step count 1 so that the sharpness annealing
and the bender's PE annealing are non-zero, with every ported loss
weighted: the loss and every metric at 1e-5 relative, every parameter
gradient at 1e-4 of its tensor's largest magnitude (f32 sums in another
order through ~20 layers), the running statistics after the step at 1e-5.
The parameters after the step: Adam's first update is lr * g / (|g| +
1e-8), about lr * sign(g), so an element whose gradient is at the level of
that summation noise may step either way; each parameter is held to 1e-5
where its gradient exceeds 1e-3 of the tensor's largest, and within 2 lr
+ 1e-6 everywhere. Randomness is off (no perturbation, no style shuffle,
the whole-image strided grid), as the card-vs-CPU check of chip_smoke.py
has it; the random draws are held to JAX's in
test_torch_port_composer.py by handing both sides the same draws.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.data.batching import Batch as JaxBatch
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.train import trainer_synthesis as jax_trainer
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.render.fast import frame_rays, render_rays_fast
from playableenvironments_tpu_torch.train import trainer_synthesis
from playableenvironments_tpu_torch.utils.random import RngStreams
from test_environment_model import tiny_scene
from test_torch_port_play import _perturbed

B, T, C, H, W = 2, 2, 1, 16, 24
STRIDES = (4, 8)
WEIGHTS = dict(reconstruction=1.0, ray_object_distance=0.1, bounding_box=0.1, displacements_magnitude=0.1,
               opacity=0.01, attention=0.01, sharpness=0.01)
LEARNING_RATE = 5e-4
FIRST_STEP = 1


def to_port(value):
    """A JAX config dataclass -> the port's class of the same name."""
    if dataclasses.is_dataclass(value):
        cls = getattr(port_config, type(value).__name__)
        return cls(**{f.name: to_port(getattr(value, f.name)) for f in dataclasses.fields(value)})
    if isinstance(value, tuple):
        return tuple(to_port(v) for v in value)
    return value


def fused_scene(use_fused_backbone=True):
    """tiny_scene with the fused backbone, and the background encoder's
    crop raised from 8x16 to 32x64: at 8x16 its last blocks normalize 4
    values per channel, a batch norm whose backward amplifies f32 noise by
    ~1e3 and leaves its gradients reproducible only to ~2%."""
    scene = tiny_scene()
    return dataclasses.replace(
        scene,
        object_models=tuple(
            dataclasses.replace(om, nerf=dataclasses.replace(om.nerf, use_fused_backbone=use_fused_backbone))
            for om in scene.object_models
        ),
        object_encoders=(dataclasses.replace(scene.object_encoders[0], input_size=(32, 64)),)
        + scene.object_encoders[1:],
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
        focals=np.full((B, T, C), 30.0, np.float32), bounding_boxes=boxes,
        bounding_boxes_validity=validity, global_frame_indexes=frames,
        video_frame_indexes=frames, video_indexes=np.zeros((B,), np.int32),
    )


def training_config(module):
    return module.SynthesisTrainingConfig(
        samples_per_image=0, patch_strides=STRIDES, perturb=False, shuffle_style=False, max_steps=4,
        loss_weights=module.LossWeights(**WEIGHTS),
    )


@functools.lru_cache(maxsize=None)
def jax_run():
    """(variables before the step, (loss, metrics, grads, variables after)),
    all numpy."""
    scene = fused_scene()
    model = JaxEnvironmentModel(scene, focal_length_multiplier=1.0)
    trainer = jax_trainer.SynthesisTrainer(model, training_config(jax_trainer))
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in batch_arrays().items()})
    state = trainer.init_state(jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(1)
    params = _perturbed(jax.device_get(state.params), rng)
    stats = _perturbed(jax.device_get(state.batch_stats), rng)
    state = state.replace(params=params, batch_stats=stats, opt_state=state.tx.init(params),
                          step=jnp.asarray(FIRST_STEP, jnp.int32))
    initial = {"params": params, "batch_stats": stats}

    @jax.jit
    def step(state, key):
        def loss_fn(p):
            return trainer.compute_losses(p, state.batch_stats, batch, key, state.step)

        (loss, (metrics, new_stats, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        new_state = state.apply_gradients(grads).replace(batch_stats=new_stats)
        return new_state, loss, metrics, grads

    state, loss, metrics, grads = step(state, jax.random.PRNGKey(0))
    after = {"params": state.params, "batch_stats": state.batch_stats}
    return initial, jax.device_get((loss, metrics, grads, after))


def port_model(variables):
    model = EnvironmentModel(to_port(fused_scene()), device="cpu")
    skipped = load_environment_model(model, variables)
    assert skipped == []
    return model


@pytest.fixture(scope="module")
def port_run():
    initial, _ = jax_run()
    model = port_model(initial)
    trainer = trainer_synthesis.SynthesisTrainer(model, training_config(trainer_synthesis))
    batch = Batch(**{k: torch.from_numpy(v) for k, v in batch_arrays().items()})
    trainer.optimizer.step_count = FIRST_STEP
    model.train()
    trainer.optimizer.zero_grad()
    loss, metrics, _ = trainer.compute_losses(batch, RngStreams(0, "cpu"), trainer.step)
    loss.backward()
    grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    trainer.optimizer.step()
    assert trainer.step == FIRST_STEP + 1
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads, model.state_dict()


def jax_as_state(tree):
    """A flax variables tree as the port's state_dict (by loading it)."""
    return port_model(tree).state_dict()


def test_loss_and_metrics_match_jax(port_run):
    jloss, jmetrics, _, _ = jax_run()[1]
    loss, metrics, _, _ = port_run
    assert set(metrics) == set(jmetrics)
    assert metrics["coarse_object_1_sharpness_loss"] > 0
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=1e-5, atol=1e-7)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jmetrics[name]), rtol=1e-5, atol=1e-7, err_msg=name)


def jax_grads():
    initial, (_, _, grads, _) = jax_run()
    return jax_as_state({"params": grads, "batch_stats": initial["batch_stats"]})


def test_every_gradient_matches_jax(port_run):
    jgrads = jax_grads()
    grads = port_run[2]
    assert len(grads) > 100
    unused = []
    for name, grad in grads.items():
        ref = jgrads[name]
        scale = ref.abs().max().item()
        if scale == 0:  # the static background's deformation code reaches no loss
            unused.append(name)
        np.testing.assert_allclose(grad.numpy(), ref.numpy(), rtol=0, atol=1e-4 * scale, err_msg=name)
    assert unused == ["object_encoder_0.deformation_head.weight", "object_encoder_0.deformation_head.bias"]


def test_parameters_and_running_statistics_after_the_step_match_jax(port_run):
    initial, (_, _, _, after) = jax_run()
    jstate, before, jgrads = jax_as_state(after), jax_as_state(initial), jax_grads()
    state = port_run[3]
    params = {name for name, _ in port_model(initial).named_parameters()}
    for name, value in state.items():
        ref = jstate[name]
        if name in params:
            diff = (value - ref).abs()
            grad = jgrads[name].abs()
            clear = grad > 1e-3 * grad.max()
            assert bool((diff[clear] <= 1e-6 + 1e-5 * ref[clear].abs()).all()), name
            assert bool((diff <= 2 * LEARNING_RATE + 1e-6).all()), name
            assert torch.equal(value, before[name]) == (grad.max() == 0), name
        else:
            np.testing.assert_allclose(value.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    stats_moved = [n for n in state if n not in params and not torch.equal(state[n], before[n])]
    assert len(stats_moved) > 50


def test_unported_options_raise():
    """Nothing falls back: each option of the phase-2 path that is not
    ported raises where it is asked for; today the three consistency
    weights, and the fast eval path for `use_fine` objects, as the JAX
    fast path does. The decoder path (patch sampling and
    `decode_patches`), the training composer's overlap fix, the phase-2
    perceptual weight (read and applied nowhere, as in the JAX trainer),
    `remat`, the divergence, per-frame camera offsets and the fine
    hierarchy are ported: they build and run (held against JAX by
    tests/test_torch_port_{decoder,minecraft_train,options}.py)."""
    scene = to_port(fused_scene())
    # The learned pose encoder is ported (tests/test_torch_port_minecraft.py).
    learned = dataclasses.replace(scene, parameter_encoders=(
        scene.parameter_encoders[0], dataclasses.replace(scene.parameter_encoders[1], kind="learned_v4")))
    assert hasattr(EnvironmentModel(learned, device="cpu"), "parameters_encoder_1")
    batch = Batch(**{k: torch.from_numpy(v) for k, v in batch_arrays().items()})
    overlapping = EnvironmentModel(dataclasses.replace(scene, fix_object_overlaps=True), device="cpu")
    out = overlapping.forward_from_observations(*batch.environment_model_args(), samples_per_image=0,
                                                patch_strides=STRIDES)
    assert bool(torch.isfinite(out["coarse"]["global"]["integrated_features"]).all())
    assert hasattr(EnvironmentModel(scene, enable_camera_offsets=True, device="cpu"), "camera_offsets")
    model = EnvironmentModel(scene, device="cpu")
    for changes in (dict(loss_weights=trainer_synthesis.LossWeights(pose_consistency=0.1)),
                    dict(loss_weights=trainer_synthesis.LossWeights(keypoint_consistency=0.1)),
                    dict(loss_weights=trainer_synthesis.LossWeights(keypoint_opacity=0.1))):
        with pytest.raises(NotImplementedError):
            trainer_synthesis.SynthesisTrainer(model, trainer_synthesis.SynthesisTrainingConfig(**changes))
    for changes in (dict(decode_patches=True, patch_size=8, patch_strides=STRIDES), dict(patch_size=8),
                    dict(loss_weights=trainer_synthesis.LossWeights(perceptual=0.1)), dict(remat=True),
                    dict(loss_weights=trainer_synthesis.LossWeights(divergence=0.1))):
        trainer_synthesis.SynthesisTrainer(model, trainer_synthesis.SynthesisTrainingConfig(**changes))
    with pytest.raises(ValueError, match="crop_to_patch"):
        trainer_synthesis.SynthesisTrainer(model, trainer_synthesis.SynthesisTrainingConfig(
            decode_patches=True, patch_size=8, patch_strides=STRIDES, crop_to_patch=False))
    with pytest.raises(ValueError, match="decode_patches requires"):  # the scene has no autoencoder
        model.forward_from_observations(*batch.environment_model_args(), samples_per_image=4, patch_size=8,
                                        patch_strides=STRIDES, decode_patches=True)
    with pytest.raises(ValueError, match="compute_divergence need"):  # the probes come from the streams
        model.forward_from_observations(*batch.environment_model_args(), samples_per_image=0, patch_strides=STRIDES,
                                        compute_divergence=True)
    out = model.forward_from_observations(*batch.environment_model_args(), samples_per_image=0, patch_strides=STRIDES,
                                          compute_divergence=True, rng=RngStreams(0, "cpu"))
    assert float(out["coarse"]["global"]["integrated_divergence"].detach().abs().max()) > 0
    fine = dataclasses.replace(scene, object_models=tuple(dataclasses.replace(om, use_fine=True)
                                                          for om in scene.object_models))
    fine_model = EnvironmentModel(fine, device="cpu")
    out = fine_model.forward_from_observations(*batch.environment_model_args(), samples_per_image=0,
                                               patch_strides=STRIDES)
    assert set(out) >= {"coarse", "fine"}
    encoding = out["scene_encoding"]
    with pytest.raises(NotImplementedError, match="coarse-only"):
        render_rays_fast(fine, fine_model.composer, *frame_rays(encoding, (H, W), STRIDES))
