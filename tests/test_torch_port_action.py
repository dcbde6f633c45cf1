"""The port's action module against the JAX package on the CPU, with the
same weights (carried by compat/from_flax.py) and JAX's own random draws
replayed into the port (jax.random.normal / gumbel recorded while the JAX
function is traced, as tests/test_torch_port_composer.py does):
- ActionNetwork and gumbel sampling (`compute_actions`), with the running
  statistics after;
- the centroid update and the variations;
- SequenceDiscriminator with `update_sn_stats` true and false: logits,
  parameter gradients, and the spectral norms' `u`/`sigma` after the call;
- ObjectAnimationModel.forward (action inference, centroids, the fused
  rollout, re-inference from the reconstruction).
All in f32 at 1e-5 relative and 1e-6 absolute (the same products, summed
in another order); gradients at 1e-5 of each tensor's largest magnitude.
What the forward infers from its reconstruction has gone through the
rollout's T-1 steps and then the batch-normalized action network again
(statistics over 20 values a feature): held to 1e-5 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from playableenvironments_tpu.config import ActionNetworkConfig, AnimationModelConfig, DynamicsNetworkConfig
from playableenvironments_tpu.models import action as jaction
from playableenvironments_tpu.models.discriminator import SequenceDiscriminator as JaxDiscriminator
from playableenvironments_tpu_torch.compat.from_flax import _spectral_norm_stats, load_flax_tree
from playableenvironments_tpu_torch.models import action
from playableenvironments_tpu_torch.models.discriminator import SequenceDiscriminator
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_play import _perturbed
from test_torch_port_train import to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

F32 = dict(rtol=1e-5, atol=1e-6)
BOX = ((-0.5, 0.5), (-0.5, 0.5), (0.0, 2.0))
BS, T = 4, 5
DRAWS = ("normal", "gumbel")


def anim_config(force_rotations_zero=True, layers=2):
    """A tiny animation model: 4 actions, a 3-dimensional action space,
    style 8, deformation 4, dynamics `layers` LSTM layers of 16, action
    network `layers` x 16, soft gumbel."""
    return AnimationModelConfig(
        actions_count=4, action_space_dimension=3, style_features=8, deformation_features=4,
        gumbel_temperature=1.0, hard_gumbel=False, centroid_alpha=0.1,
        dynamics=DynamicsNetworkConfig(output_features=16, layers_count=layers,
                                       force_rotations_zero=force_rotations_zero, force_z_translations_zero=True,
                                       rotation_axis=2),
        action_network=ActionNetworkConfig(layers_width=16, layers_count=layers),
    )


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, tol=F32, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol, err_msg=name)


def object_inputs(seed=0):
    """(rotations, translations, style, deformation, in_scene) of one object,
    with one object leaving the scene at the last step."""
    rng = np.random.default_rng(seed)
    in_scene = np.ones((BS, T), bool)
    in_scene[1, -1] = False
    return (rng.normal(size=(BS, T, 3)).astype(np.float32) * 0.3, rng.normal(size=(BS, T, 3)).astype(np.float32),
            rng.normal(size=(BS, T, 8)).astype(np.float32), rng.normal(size=(BS, T, 4)).astype(np.float32), in_scene)


@functools.lru_cache(maxsize=None)
def jax_animation(force_rotations_zero=False):
    """The JAX ObjectAnimationModel's perturbed variables, its forward and
    compute_actions in train mode with their recorded draws, all numpy."""
    model = jaction.ObjectAnimationModel(anim_config(force_rotations_zero), BOX)
    inputs = [jnp.asarray(x) for x in object_inputs()]
    centroids = jnp.asarray(np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32))
    rngs = {"params": jax.random.PRNGKey(0), "action_sampling": jax.random.PRNGKey(1),
            "gumbel": jax.random.PRNGKey(2)}
    variables = jax.device_get(jax.jit(lambda r, *a: model.init(r, *a, 3, centroids))(rngs, *inputs))
    variables = _perturbed(variables, np.random.default_rng(3))
    names = {}

    def record(key, fn):
        with recorded_draws(DRAWS) as draws:
            out = fn()
        names[key] = [name for name, _ in draws]
        return out, [value for _, value in draws]

    @jax.jit
    def run(variables, *inputs):
        forward = record("forward", lambda: model.apply(variables, *inputs, 2, centroids, rngs=rngs,
                                                        mutable=["batch_stats"]))
        actions = record("actions", lambda: model.apply(
            variables, inputs[0], inputs[1], inputs[3], inputs[4], False,
            method=jaction.ObjectAnimationModel.compute_actions, rngs=rngs, mutable=["batch_stats"]))
        return forward, actions

    forward, actions = jax.device_get(run(variables, *inputs))
    draws = {key: [(n, np.asarray(v)) for n, v in zip(names[key], out[1])]
             for key, out in (("forward", forward), ("actions", actions))}
    return variables, np.asarray(centroids), forward[0], actions[0], draws


def port_animation(variables, force_rotations_zero=False):
    model = action.ObjectAnimationModel(to_port(anim_config(force_rotations_zero)), BOX, device="cpu")
    load_flax_tree(model, variables["params"], variables["batch_stats"])
    return model


def check_stats(model, mutated):
    expected = port_animation({"params": jax_animation()[0]["params"], "batch_stats": mutated["batch_stats"]})
    for name, buffer in model.named_buffers():
        close(buffer, expected.get_buffer(name).numpy(), name=name)


def test_action_network_and_gumbel_sampling_match_jax():
    variables, _, _, (ref, mutated), draws = jax_animation()
    assert [n for n, _ in draws["actions"]] == ["normal", "normal", "gumbel"]
    model = port_animation(variables)
    rot, trans, _, _, in_scene = (t(x) for x in object_inputs())
    replay = Replay(draws["actions"])
    out = model.compute_actions(rot, trans, in_scene, replay)
    assert not replay.draws and replay.streams == ["action_sampling", "action_sampling", "gumbel"]
    assert set(out) == set(ref)
    for name, value in ref.items():
        close(out[name], value, name=name)
    check_stats(model, mutated)
    # Batch statistics without the running-statistics update.
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.compute_actions(rot, trans, in_scene, Replay(draws["actions"]), update_stats=False)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_centroid_update_and_variations_match_jax():
    rng = np.random.default_rng(4)
    centroids = rng.normal(size=(4, 3)).astype(np.float32)
    directions = rng.normal(size=(BS, T - 1, 2, 3)).astype(np.float32)
    probs = rng.dirichlet(np.ones(4), size=(BS, T - 1)).astype(np.float32)
    validity = rng.random((BS, T - 1)) > 0.3
    points = rng.normal(size=(BS, T - 1, 3)).astype(np.float32)
    got = action.update_centroids(t(centroids), t(directions), t(probs), t(validity), 0.1)
    close(got, jaction.update_centroids(*(jnp.asarray(x) for x in (centroids, directions, probs, validity)), 0.1))
    close(action.compute_variations(got, t(points), t(probs)),
          jaction.compute_variations(jnp.asarray(got.numpy()), jnp.asarray(points), jnp.asarray(probs)))
    in_scene = rng.random((BS, T)) > 0.2
    assert torch.equal(action.compute_sequence_validity(t(in_scene)),
                       t(jaction.compute_sequence_validity(jnp.asarray(in_scene))))


def test_sequence_discriminator_matches_jax_with_and_without_stats_update():
    rng = np.random.default_rng(5)
    sequences = rng.normal(size=(BS, T, 15)).astype(np.float32)
    validity = np.ones((BS, T), bool)
    validity[2, 3:] = False
    weights = rng.normal(size=(BS,)).astype(np.float32)
    disc = JaxDiscriminator()
    variables = jax.device_get(jax.jit(disc.init)(jax.random.PRNGKey(6), jnp.asarray(sequences),
                                                   jnp.asarray(validity)))

    @functools.partial(jax.jit, static_argnums=(1,))
    def run(params, update, stats):
        def loss(p):
            logits, mutated = disc.apply({"params": p, "batch_stats": stats}, jnp.asarray(sequences),
                                         jnp.asarray(validity), update, mutable=["batch_stats"])
            return jnp.sum(logits * weights), (logits, mutated)
        return jax.grad(loss, has_aux=True)(params)

    for update in (True, False):
        grads, (logits, mutated) = jax.device_get(run(variables["params"], update, variables["batch_stats"]))
        port = SequenceDiscriminator(15, device="cpu")
        load_flax_tree(port, variables["params"], _spectral_norm_stats(variables["batch_stats"]))
        before = {k: v.clone() for k, v in port.named_buffers()}
        got = port(t(sequences), t(validity), update)
        close(got, logits)
        (got * t(weights)).sum().backward()
        expected = SequenceDiscriminator(15, device="cpu")
        load_flax_tree(expected, grads, _spectral_norm_stats(mutated["batch_stats"]))
        for name, p in port.named_parameters():
            ref = expected.get_parameter(name)
            close(p.grad, ref.detach().numpy(), dict(rtol=0, atol=1e-5 * ref.abs().max().item()), name)
        for name, buffer in port.named_buffers():
            close(buffer, expected.get_buffer(name).numpy(), name=name)
        # Every u and sigma moves with the update (but final_fc's u, a unit
        # (1, 1) vector), none without it.
        changed = [n for n, b in port.named_buffers() if not torch.equal(b, before[n])]
        assert len(changed) == (7 if update else 0), changed


def test_object_animation_model_forward_matches_jax():
    variables, centroids, (ref, mutated), _, draws = jax_animation()
    assert [n for n, _ in draws["forward"]] == ["normal", "normal", "gumbel"] * 2
    model = port_animation(variables)
    rot, trans, style, deform, in_scene = (t(x) for x in object_inputs())
    replay = Replay(draws["forward"])
    out = model(rot, trans, style, deform, in_scene, 2, t(centroids), replay)
    assert not replay.draws
    assert set(out) == set(ref)
    for name, value in ref.items():
        if value.dtype == bool:
            assert np.array_equal(out[name].numpy(), value), name
        else:
            close(out[name], value, dict(rtol=1e-5, atol=1e-5) if name.startswith("reconstructed_") else F32, name)
    check_stats(model, mutated)
