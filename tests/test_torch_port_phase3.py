"""One whole phase-3 fused step (generator, then discriminator) of the port
against the JAX package's `PlayableTrainer.fused_step` on the CPU: a tiny
scene with two players (one with rotations forced to zero, one free; one
LSTM layer and one action-network layer each, to keep the JAX compile
short: the two-layer paths are held in test_torch_port_rollout.py and
test_torch_port_action.py), a numpy scene encoding with one player leaving
the scene, the GAN, ACMV and entropy losses on; the same seeded weights
(the JAX variables' shapes from jax.eval_shape of the trainer's own
init_state_from_encoding, values from numpy; carried over by
compat/from_flax.py), centroids and MI matrices; JAX's own random draws
(`action_sampling` normals, `gumbel`) replayed into the port.

Compared: the loss and every metric (1e-5 relative); every gradient of the
generator pass, the discriminators' included (1e-4 of each tensor's largest
magnitude: f32 sums in another order through the rollout and the
batch-normalized action networks, plus 1e-6 of its model's largest
gradient for the biases before a batch norm, whose gradient is noise); the running statistics, the spectral
norms' u/sigma, the centroids and the MI matrices after each pass (1e-5).
Parameters after each pass: Adam's first update is about lr sign(g), so an
element whose gradient sits at the level of that noise may step either
way; each parameter is held to 1e-6 + 1e-5 |ref| where its gradient
exceeds 1e-3 of its tensor's largest and twice the gradient tolerance,
and within 2 lr + 1e-6 everywhere
(the discriminator step's gradients, which the JAX step does not return,
are the port's: their sign must agree with JAX's update where it is clear).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.render.playable_model import PlayableEnvironmentModel as JaxPlayable
from playableenvironments_tpu.scene.encoding import SceneEncoding as JaxEncoding
from playableenvironments_tpu.train import trainer_playable as jtrainer
from playableenvironments_tpu_torch.compat.from_flax import load_playable, load_playable_extra
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.train import trainer_playable
from test_environment_model import tiny_scene
from test_torch_port_action import anim_config
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_train import to_port

BS, T, N_OBJ = 4, 4, 3
LEARNING_RATE = 5e-4
WEIGHTS = dict(gan=0.1, acmv=0.1, entropy=0.01)
GT_START = 2  # steps 0 and 1 read the ground truth, step 2 its own prediction


def scene():
    """tiny_scene with a second player; the two animation models differ in
    the rotation branch."""
    base = tiny_scene()
    background, player = base.object_models
    return dataclasses.replace(
        base, object_models=(background, player, dataclasses.replace(player, name="player_2")),
        parameter_encoders=base.parameter_encoders + base.parameter_encoders[1:],
        object_encoders=base.object_encoders + base.object_encoders[1:],
        sampling_weights=(0.5, 0.25, 0.25), animation_models=(anim_config(True, 1), anim_config(False, 1)),
    )


def encoding_arrays(seed=0):
    rng = np.random.default_rng(seed)
    in_scene = np.ones((BS, T, N_OBJ), bool)
    in_scene[2, 2:, 2] = False
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return dict(
        camera_rotations=normal(BS, T, 1, 3) * 0.1, camera_translations=normal(BS, T, 1, 3),
        focals=np.full((BS, T, 1), 30.0, np.float32), object_rotations=normal(BS, T, N_OBJ, 3) * 0.1,
        object_translations=normal(BS, T, N_OBJ, 3), object_style=normal(BS, T, N_OBJ, 8),
        object_deformation=normal(BS, T, N_OBJ, 4), object_in_scene=in_scene,
    )


def seeded_tree(tree, rng, path=()):
    """Values for a tree of shapes: kernels normal / sqrt(fan in), BN scales
    and variances near 1, spectral-norm u normal and sigma 1, everything
    else (biases, BN means, initial states) normal * 0.3."""
    out = {}
    for name, leaf in tree.items():
        if hasattr(leaf, "items"):
            out[name] = seeded_tree(leaf, rng, path + (name,))
            continue
        shape = leaf.shape
        if name == "kernel":
            value = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            value = rng.uniform(0.7, 1.3, shape)
        elif name.endswith("/sigma"):
            value = np.ones(shape)
        elif name.endswith("/u"):
            value = rng.normal(size=shape)
        else:
            value = rng.normal(size=shape) * 0.3
        out[name] = np.asarray(value, np.float32)
    return out


def training_config(module):
    return module.PlayableTrainingConfig(ground_truth_observations_start=GT_START, learning_rate=LEARNING_RATE,
                                         loss_weights=module.PlayableLossWeights(**WEIGHTS))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX trainer's state before the step (perturbed), the generator
    pass's gradients and metrics, the state after G and after D, the D
    metrics and the recorded draws; all numpy."""
    jscene = scene()
    trainer = jtrainer.PlayableTrainer(JaxEnvironmentModel(jscene), JaxPlayable(jscene, with_discriminators=True),
                                       training_config(jtrainer))
    encoding = JaxEncoding(**{k: jnp.asarray(v) for k, v in encoding_arrays().items()})
    # Traced, not compiled (its inner jits are traced too); it also builds
    # the trainer's two optimizers.
    shapes = jax.eval_shape(lambda e: trainer.init_state_from_encoding(jax.random.PRNGKey(0), e, {}, {}), encoding)
    rng = np.random.default_rng(1)
    params = seeded_tree(shapes.params, rng)
    stats = seeded_tree(shapes.batch_stats, rng)
    extra = {"centroids": {str(i): rng.normal(size=(4, 3)).astype(np.float32) for i in range(2)},
             "mi_matrices": {str(i): np.full((4, 4), 1 / 16, np.float32) for i in range(2)},
             "environment": {"params": {}, "batch_stats": {}}, "disc_opt_state": trainer.tx_disc.init(params)}
    state = shapes.replace(params=params, batch_stats=stats, opt_state=shapes.tx.init(params), extra=extra,
                           step=jnp.asarray(0, jnp.int32))
    names = []

    @functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                                                  "xla_llvm_disable_expensive_passes": True})
    def run(state, key):
        # fused_step, with the generator pass's gradients kept.
        key_gen, key_disc = jax.random.split(key)
        with recorded_draws(("normal", "gumbel")) as draws:
            def loss_fn(p):
                return trainer.compute_losses(p, state.batch_stats, state.extra, encoding, key_gen, state.step)

            (_, (metrics, new_stats, new_extra, _, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params)
            after_g = state.apply_gradients(grads).replace(batch_stats=new_stats, extra=new_extra)
            after_d, d_metrics = trainer.discriminator_step(after_g, encoding, key_disc, state.step)
        names[:] = [name for name, _ in draws]
        keep = lambda s: {"params": s.params, "batch_stats": s.batch_stats, "centroids": s.extra["centroids"],  # noqa: E731
                          "mi_matrices": s.extra["mi_matrices"], "step": s.step}
        return grads, {**metrics, **d_metrics}, keep(after_g), keep(after_d), [v for _, v in draws]

    grads, metrics, after_g, after_d, values = jax.device_get(run(state, jax.random.PRNGKey(3)))
    before = {"params": params, "batch_stats": stats, "centroids": extra["centroids"],
              "mi_matrices": extra["mi_matrices"]}
    return before, grads, metrics, after_g, after_d, [(n, np.asarray(v)) for n, v in zip(names, values)]


def port_model(params, batch_stats):
    model = PlayableEnvironmentModel(to_port(scene()), with_discriminators=True, device="cpu")
    assert load_playable(model, {"params": params, "batch_stats": batch_stats}) == []
    return model


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's fused_step from the same state and draws: the gradients
    and state when the generator step ends, the metrics and state after."""
    before, _, _, _, _, draws = jax_step
    model = port_model(before["params"], before["batch_stats"])
    trainer = trainer_playable.PlayableTrainer(model, training_config(trainer_playable))
    load_playable_extra(trainer, before)
    encoding = SceneEncoding(**{k: torch.from_numpy(v) for k, v in encoding_arrays().items()})
    replay = Replay(draws)
    after_g = {}
    discriminator_step = trainer.discriminator_step

    def capture(*args):
        after_g.update(grads={n: p.grad.clone() for n, p in model.named_parameters()},
                       state={k: v.clone() for k, v in model.state_dict().items()},
                       centroids=[c.clone() for c in trainer.centroids],
                       mi_matrices=[m.clone() for m in trainer.mi_matrices], step=trainer.step, args=args[2:])
        return discriminator_step(*args)

    trainer.discriminator_step = capture
    metrics = trainer.fused_step(encoding, replay)
    assert not replay.draws
    assert replay.streams == ["action_sampling", "action_sampling", "gumbel"] * 8
    d_grads = {n: p.grad.clone() for n, p in model.named_parameters() if n.startswith("discriminator")}
    # Each Adam has its own schedule count; the pair advanced the step once.
    assert trainer.optimizer.step_count == trainer.discriminator_optimizer.step_count == 1
    # The centroids and MI matrices are the generator pass's.
    for key in ("centroids", "mi_matrices"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(trainer, key), after_g[key])), key
    return metrics, after_g, {"state": model.state_dict(), "grads": d_grads, "step": trainer.step}


def as_state(tree, stats):
    return port_model(tree, stats).state_dict()


def test_loss_and_metrics_match_jax(jax_step, port_step):
    _, _, jmetrics, _, _, draws = jax_step
    metrics = port_step[0]
    assert [n for n, _ in draws] == ["normal", "normal", "gumbel"] * 8  # 2 players x 2 inferences x G and D
    assert set(metrics) == set(jmetrics) and "discriminator_loss" in metrics
    assert "object_2_gan_generator_loss" in metrics and "object_1_acmv_loss" in metrics
    for name, value in metrics.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jmetrics[name]), rtol=1e-5, atol=1e-7, err_msg=name)


def test_every_generator_gradient_matches_jax(jax_step, port_step):
    before, jgrads, _, _, _, _ = jax_step
    grads = port_step[1]["grads"]
    ref = as_state(jgrads, before["batch_stats"])
    assert set(grads) == {n for n, _ in port_model(before["params"], before["batch_stats"]).named_parameters()}
    atol = gradient_tolerances(ref, grads)
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), ref[name].numpy(), rtol=0, atol=atol[name], err_msg=name)
    # The generator's GAN loss reaches the discriminators (the JAX optimizer
    # masks this gradient; the port's discriminator step clears it).
    assert any(grads[n].abs().max() > 0 for n in grads if n.startswith("discriminator"))


def gradient_tolerances(grads, names):
    """{name: absolute tolerance}: 1e-4 of the tensor's largest gradient,
    plus 1e-6 of its model's. A bias that feeds a batch norm has no
    gradient but f32 noise (the norm removes the mean), which the second
    term covers."""
    group_scale = {}
    for name in names:
        group = name.split(".")[0]
        group_scale[group] = max(group_scale.get(group, 0.0), grads[name].abs().max().item())
    return {name: 1e-4 * grads[name].abs().max().item() + 1e-6 * group_scale[name.split(".")[0]] for name in names}


def check_parameters(state, ref, grads, names):
    """Parameters after an Adam step: tight where the gradient's sign is
    clear of the noise, within 2 lr everywhere."""
    atol = gradient_tolerances(grads, names)
    for name in names:
        diff = (state[name] - ref[name]).abs()
        grad = grads[name].abs()
        clear = grad > max(1e-3 * grad.max().item(), 2 * atol[name])
        assert bool((diff[clear] <= 1e-6 + 1e-5 * ref[name][clear].abs()).all()), name
        assert bool((diff <= 2 * LEARNING_RATE + 1e-6).all()), name


def test_state_after_the_generator_step_matches_jax(jax_step, port_step):
    before, jgrads, _, jafter_g, _, _ = jax_step
    after_g = port_step[1]
    state, ref = after_g["state"], as_state(jafter_g["params"], jafter_g["batch_stats"])
    start = as_state(before["params"], before["batch_stats"])
    grads = as_state(jgrads, before["batch_stats"])
    params = set(after_g["grads"])
    generator = [n for n in params if not n.startswith("discriminator")]
    check_parameters(state, ref, grads, generator)
    for name in params - set(generator):  # the generator step leaves the discriminators alone
        assert torch.equal(state[name], start[name]), name
    buffers = [n for n in state if n not in params]
    for name in buffers:  # BN statistics updated twice per player; u/sigma untouched
        np.testing.assert_allclose(state[name].numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    assert all(torch.equal(state[n], start[n]) == ("discriminator" in n) for n in buffers)
    for key in ("centroids", "mi_matrices"):
        for i, value in enumerate(after_g[key]):
            np.testing.assert_allclose(value.numpy(), jafter_g[key][str(i)], rtol=1e-5, atol=1e-6, err_msg=key)
            assert not np.array_equal(value.numpy(), before[key][str(i)]), key
    assert after_g["step"] == int(jafter_g["step"]) == 1
    assert after_g["args"] == (0,)  # the discriminator step reads the pre-generator step


def test_state_after_the_discriminator_step_matches_jax(jax_step, port_step):
    _, _, _, jafter_g, jafter_d, _ = jax_step
    after_g, after_d = port_step[1], port_step[2]
    state, ref = after_d["state"], as_state(jafter_d["params"], jafter_d["batch_stats"])
    params = set(after_g["grads"])
    discriminator = [n for n in params if n.startswith("discriminator")]
    check_parameters(state, ref, after_d["grads"], discriminator)
    for name in discriminator:
        move = ref[name] - as_state(jafter_g["params"], jafter_g["batch_stats"])[name]
        clear = after_d["grads"][name].abs() > 1e-3 * after_d["grads"][name].abs().max()  # D has no batch norm
        assert bool((torch.sign(move[clear]) == -torch.sign(after_d["grads"][name][clear])).all()), name
    for name in params - set(discriminator):
        assert torch.equal(state[name], after_g["state"][name]), name
    for name in (n for n in state if n not in params):
        np.testing.assert_allclose(state[name].numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        # D discards the action networks' statistics and moves every u/sigma.
        moved = not torch.equal(state[name], after_g["state"][name])
        assert moved == ("discriminator" in name), name
    assert after_d["step"] == int(jafter_d["step"]) == 1
