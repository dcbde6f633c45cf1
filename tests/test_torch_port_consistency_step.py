"""One whole phase-2 step with the consistency losses on, the port against
the JAX package's `SynthesisTrainer.compute_losses` on the CPU.

tests/test_torch_port_train.py's tiny scene (a background and a bent
player, the fused backbone: B2/B3's Pallas kernels in interpret mode on the
JAX side, their plain versions in the port) on the direct-ray path (12
weighted rays an image), perturbation and the style shuffle on, every
phase-2 weight of that test plus pose consistency 1.0, keypoint
consistency 1.0 and keypoint opacity 0.1 (16 samples an image, the
threshold 0.3). The batch carries an optical flow (a constant shift plus
noise) and 17 keypoints inside the player's projection, a third of them
at 0.3 (on the gates) and a third below. The port draws (its CPU
RngStreams) and JAX replays the same numbers, so the order of the draws is held too: the main
forward's, then the pose pass's, then the keypoint pass's.

Compared: the loss and every metric, the three consistency metrics
included, at 2e-4 relative; every gradient at 2e-3 of its tensor's largest
(plus 1e-6 of its model's: test_torch_port_phase3.gradient_tolerances)
except the object encoders' at 2e-2: on these seeded weights the
background encoder's gradients sit 1.26e-2 of their largest from JAX's,
with the passes and without them alike (its batch norms' conditioning,
which tests/test_torch_port_options.py measures), the player's 4.3e-4 and
the composer's 5.6e-5; the parameters after
the Adam step (tight where the gradient's sign is clear, within 2 lr
everywhere); the running statistics after the step at 1e-4, which must be
the main forward's alone: the passes run with batch statistics and leave
them as they are, as JAX discards what its passes mutate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from playableenvironments_tpu.data.batching import Batch as JaxBatch
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.train import trainer_synthesis as jax_trainer
from playableenvironments_tpu.train.state import create_train_state, make_optimizer
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.train import trainer_synthesis
from test_torch_port_decoder import NO_OPT
from test_torch_port_options import RecordingStreams, draws_into_jax
from test_torch_port_phase3 import gradient_tolerances, seeded_tree
from test_torch_port_train import batch_arrays, fused_scene, to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

WEIGHTS = dict(reconstruction=1.0, ray_object_distance=0.1, bounding_box=0.1, displacements_magnitude=0.1,
               opacity=0.01, attention=0.01, sharpness=0.01, pose_consistency=1.0, keypoint_consistency=1.0,
               keypoint_opacity=0.1)
LEARNING_RATE = 5e-4
FIRST_STEP = 1
METRIC_RTOL, GRADIENT_RTOL, ENCODER_RTOL, STATS_TOL = 2e-4, 2e-3, 2e-2, 1e-4
CONSISTENCY_METRICS = {"dynamic_object_0_pose_consistency_loss", "dynamic_object_0_keypoint_consistency_loss",
                       "dynamic_object_0_keypoint_opacity_loss"}


def t(x):
    return torch.from_numpy(np.array(x))


def step_arrays():
    """test_torch_port_train.py's batch with a flow and keypoints."""
    arrays = batch_arrays()
    b, steps, c, h, w = arrays["observations"].shape[:5]
    rng = np.random.default_rng(20)
    # The player projects ~0.3 of the image below its dataset box here: the
    # flow carries the box's rays down onto it.
    arrays["optical_flow"] = (np.asarray([0.2, -0.01], np.float32)
                              + rng.normal(size=(b, steps, c, h, w, 2)) * 0.01).astype(np.float32)
    # Keypoints inside the player's projection (rows 0.59-0.92, columns
    # 0.42-0.54 of the image at this camera).
    fractions = rng.uniform(0.0, 1.0, (b, steps, c, 17, 2)).astype(np.float32)
    rows = 0.68 + 0.2 * fractions[..., 0]
    cols = 0.44 + 0.08 * fractions[..., 1]
    confidence = rng.choice(np.asarray([0.1, 0.3, 0.8], np.float32), (b, steps, c, 17))
    arrays["keypoints"] = np.stack([rows, cols, confidence], axis=-1)[..., None].astype(np.float32)
    arrays["keypoints_validity"] = arrays["bounding_boxes_validity"].copy()
    return arrays


def step_config(module):
    return module.SynthesisTrainingConfig(
        learning_rate=LEARNING_RATE, samples_per_image=12, perturb=True, shuffle_style=True, max_steps=4,
        loss_weights=module.LossWeights(**WEIGHTS))


@functools.lru_cache(maxsize=None)
def initial_variables():
    model = JaxEnvironmentModel(fused_scene())
    cfg = step_config(jax_trainer)
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in step_arrays().items()})
    shapes = jax.eval_shape(lambda k: model.init({**jax_trainer.split_rngs(k), "params": k},
                                                 *batch.environment_model_args(),
                                                 samples_per_image=cfg.samples_per_image), jax.random.PRNGKey(0))
    return {kind: seeded_tree(shapes[kind], np.random.default_rng(21)) for kind in ("params", "batch_stats")}


def port_model(tree):
    model = EnvironmentModel(to_port(fused_scene()), device="cpu")
    assert load_environment_model(model, tree) == []
    return model


@functools.lru_cache(maxsize=None)
def port_run():
    """((loss, metrics, grads, state after), draws) of the port's step."""
    model = port_model(initial_variables())
    trainer = trainer_synthesis.SynthesisTrainer(model, step_config(trainer_synthesis))
    trainer.optimizer.step_count = FIRST_STEP
    model.train()
    trainer.optimizer.zero_grad()
    streams = RecordingStreams(22)
    loss, metrics, _ = trainer.compute_losses(Batch(**{k: t(v) for k, v in step_arrays().items()}), streams,
                                              trainer.step)
    loss.backward()
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p) for n, p in model.named_parameters()}
    trainer.optimizer.step()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()}), streams.draws


@functools.lru_cache(maxsize=None)
def jax_run():
    """JAX's step on the port's draws: (loss, metrics, grads, variables after)."""
    model = JaxEnvironmentModel(fused_scene())
    trainer = jax_trainer.SynthesisTrainer(model, step_config(jax_trainer))
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in step_arrays().items()})
    initial = initial_variables()
    tx = make_optimizer(LEARNING_RATE, 0.926118, 10000, 0.0)
    state = create_train_state(initial["params"], initial["batch_stats"], tx).replace(
        step=jnp.asarray(FIRST_STEP, jnp.int32))
    draws = port_run()[1]

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def step(state):
        with draws_into_jax(draws) as pending:
            def loss_fn(p):
                return trainer.compute_losses(p, state.batch_stats, batch, jax.random.PRNGKey(0), state.step)

            (loss, (metrics, new_stats, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
            assert not pending, f"{len(pending)} draws left over"
        new_state = state.apply_gradients(grads).replace(batch_stats=new_stats)
        return loss, metrics, grads, {"params": new_state.params, "batch_stats": new_state.batch_stats}

    return jax.device_get(step(state))


def test_draws_follow_the_passes_order():
    """The main forward's draws (style shuffle per object, the weighted
    rays, the composer's strata and alpha noise), then per player the pose
    pass's box draw and each frame's strata and noise, then the keypoint
    pass's fractions, strata and noise."""
    streams = [stream for _, stream, _ in port_run()[1]]
    main = ["style_shuffle"] * 2 + ["ray_sampling"] + ["sampling"] * 2 + ["alpha_noise"] * 3
    assert streams == main + ["sampling", "sampling", "alpha_noise", "sampling", "alpha_noise"] + [
        "sampling", "sampling", "alpha_noise"]


def test_consistency_step_matches_jax():
    jloss, jmetrics, jgrads, jafter = jax_run()
    loss, metrics, grads, state = port_run()[0]
    assert set(metrics) == set(jmetrics) and CONSISTENCY_METRICS <= set(metrics)
    assert all(float(metrics[name]) > 0 for name in CONSISTENCY_METRICS)
    for name, value in list(metrics.items()) + [("loss", loss)]:
        np.testing.assert_allclose(value.numpy(), np.asarray(jmetrics[name]), rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=name)
    initial = initial_variables()
    ref_grads = port_model({"params": jgrads, "batch_stats": initial["batch_stats"]}).state_dict()
    atol = {name: 1e4 * (ENCODER_RTOL if name.startswith("object_encoder_") else GRADIENT_RTOL) * tol
            for name, tol in gradient_tolerances(ref_grads, list(grads)).items()}
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(), rtol=0, atol=atol[name], err_msg=name)
    ref_state, start = port_model(jafter).state_dict(), port_model(initial).state_dict()
    stats = [name for name in state if name not in grads]
    for name in grads:
        diff, grad = (state[name] - ref_state[name]).abs(), ref_grads[name].abs()
        clear = grad > max(1e-3 * grad.max().item(), 2 * atol[name])
        assert bool((diff[clear] <= 1e-6 + 1e-5 * ref_state[name][clear].abs()).all()), name
        assert bool((diff <= 2 * LEARNING_RATE + 1e-6).all()), name
    for name in stats:
        np.testing.assert_allclose(state[name].numpy(), ref_state[name].numpy(), rtol=1e-5, atol=STATS_TOL,
                                   err_msg=name)
    assert sum(not torch.equal(state[n], start[n]) for n in stats) > 20


def test_passes_leave_the_running_statistics_to_the_main_forward():
    """The same step without the consistency weights moves every running
    statistic exactly as the step with them: the passes update none."""
    model = port_model(initial_variables())
    config = trainer_synthesis.SynthesisTrainingConfig(
        learning_rate=LEARNING_RATE, samples_per_image=12, perturb=True, shuffle_style=True, max_steps=4,
        loss_weights=trainer_synthesis.LossWeights(**{k: v for k, v in WEIGHTS.items()
                                                      if "consistency" not in k and k != "keypoint_opacity"}))
    trainer = trainer_synthesis.SynthesisTrainer(model, config)
    model.train()
    draws = port_run()[1]
    streams = RecordingStreams(22)
    trainer.compute_losses(Batch(**{k: t(v) for k, v in step_arrays().items()}), streams, FIRST_STEP)
    assert len(streams.draws) == len(draws) - 8 and all(
        np.array_equal(a[2], b[2]) for a, b in zip(streams.draws, draws))
    with_passes = port_run()[0][3]
    params = {n for n, _ in model.named_parameters()}
    for name, value in model.state_dict().items():
        if name not in params:
            assert torch.equal(value, with_passes[name]), name
