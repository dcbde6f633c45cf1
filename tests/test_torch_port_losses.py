"""The port's phase-2 and phase-3 losses and its optimizer against the JAX
package on the CPU: each loss on seeded inputs (1e-6 relative), and three
Adam / AdamW steps of train/state.py::Optimizer against optax's
make_optimizer with the staircase schedule crossing a decay boundary,
per-group rates and a frozen group (1e-6)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from playableenvironments_tpu.train import losses as jlosses
from playableenvironments_tpu.train.state import make_optimizer
from playableenvironments_tpu_torch.train import losses
from playableenvironments_tpu_torch.train.state import Optimizer
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

TOL = dict(rtol=1e-6, atol=1e-7)


def t(x):
    return torch.from_numpy(np.array(x))


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    obs = rng.random((2, 3, 1, 10, 3)).astype(np.float32)
    rec = rng.random((2, 3, 1, 10, 3)).astype(np.float32)
    distances = rng.random((2, 3, 1, 10, 2)).astype(np.float32)
    boxes = rng.random((2, 3, 1, 2, 4)).astype(np.float32)
    rboxes = rng.random((2, 3, 1, 2, 4)).astype(np.float32)
    validity = rng.random((2, 3, 1, 2)) > 0.3
    opacity = rng.random((2, 3, 1, 10)).astype(np.float32)
    attention = rng.random((2, 3, 4, 4, 1)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in locals().items() if isinstance(v, np.ndarray)}
    pairs = [
        (losses.masked_mean(t(opacity), t(validity[..., 0])[..., None]), jlosses.masked_mean(j["opacity"], j["validity"][..., 0][..., None])),
        (losses.masked_mean(t(opacity), None), jlosses.masked_mean(j["opacity"], None)),
        (losses.reconstruction_loss(t(obs), t(rec)), jlosses.reconstruction_loss(j["obs"], j["rec"])),
        (losses.ray_object_distance_loss(t(obs), t(rec), t(distances)),
         jlosses.ray_object_distance_loss(j["obs"], j["rec"], j["distances"])),
        (losses.opacity_loss(t(opacity), t(validity[..., 1])), jlosses.opacity_loss(j["opacity"], j["validity"][..., 1])),
        (losses.attention_loss(t(attention), t(validity[:, :, 0, 1])),
         jlosses.attention_loss(j["attention"], j["validity"][:, :, 0, 1])),
        (losses.sharpness_loss(t(opacity), t(validity[..., 0]), 0.4, 0.2),
         jlosses.sharpness_loss(j["opacity"], j["validity"][..., 0], 0.4, 0.2)),
    ]
    total, per_object = losses.bounding_box_distance_loss(t(boxes), t(rboxes), t(validity))
    jtotal, jper_object = jlosses.bounding_box_distance_loss(j["boxes"], j["rboxes"], j["validity"])
    pairs += [(total, jtotal), (per_object, jper_object)]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Linear(3, 2)
        self.b = nn.Linear(2, 1, bias=False)


@pytest.mark.parametrize("weight_decay,groups", [(0.0, False), (0.01, False), (0.0, True)])
def test_three_adam_steps_match_optax(weight_decay, groups):
    rng = np.random.default_rng(1)
    model = Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(t(rng.normal(size=p.shape).astype(np.float32)))
    group_lrs = {"b": 2e-3} if groups else None
    freeze = {"b": 2} if groups else None
    tx = make_optimizer(1e-2, gamma=0.5, decay_iterations=2, weight_decay=weight_decay,
                        group_learning_rates=group_lrs, group_freeze_steps=freeze)
    # flax layout: Dense kernels (in, out); copies, since jnp.asarray may
    # share a numpy view's memory, which the torch optimizer updates in place.
    def copy(p, transpose=True):
        value = p.detach().numpy().copy()
        return jnp.asarray(value.T.copy() if transpose else value)

    params = {"a": {"kernel": copy(model.a.weight), "bias": copy(model.a.bias, False)},
              "b": {"kernel": copy(model.b.weight)}}
    state = tx.init(params)
    opt = Optimizer(model, 1e-2, gamma=0.5, decay_iterations=2, weight_decay=weight_decay,
                    group_learning_rates=group_lrs, group_freeze_steps=freeze)
    for step in range(3):
        grads = {name: rng.normal(size=p.shape).astype(np.float32) for name, p in model.named_parameters()}
        for name, p in model.named_parameters():
            p.grad = t(grads[name])
        opt.step()
        jgrads = {"a": {"kernel": jnp.asarray(grads["a.weight"].T), "bias": jnp.asarray(grads["a.bias"])},
                  "b": {"kernel": jnp.asarray(grads["b.weight"].T)}}
        updates, state = tx.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(model.a.weight.detach().numpy(), np.asarray(params["a"]["kernel"]).T, **TOL)
        np.testing.assert_allclose(model.a.bias.detach().numpy(), np.asarray(params["a"]["bias"]), **TOL)
        np.testing.assert_allclose(model.b.weight.detach().numpy(), np.asarray(params["b"]["kernel"]).T, **TOL)
    assert opt.step_count == 3


def test_phase3_losses_match_jax():
    """The phase-3 losses on seeded inputs (1e-6 relative): Gaussian KL,
    entropy, the joint matrix and the EMA-smoothed mutual information with
    its carried matrix, both GAN modes, ACMV and its camera-relative
    movements; a single-camera check and the missing axis raise."""
    rng = np.random.default_rng(2)
    dist = rng.normal(size=(3, 4, 2, 5)).astype(np.float32)
    logits = rng.normal(size=(3, 4, 6)).astype(np.float32)
    p1 = rng.dirichlet(np.ones(6), size=(3, 4)).astype(np.float32)
    p2 = rng.dirichlet(np.ones(6), size=(3, 4)).astype(np.float32)
    smoothing = rng.dirichlet(np.ones(36)).reshape(6, 6).astype(np.float32)
    prediction = rng.normal(size=(7,)).astype(np.float32) * 3
    movements = rng.normal(size=(3, 4, 3)).astype(np.float32)
    camera_rotations = rng.normal(size=(3, 5, 1, 3)).astype(np.float32)
    j = lambda x: jnp.asarray(x)  # noqa: E731
    mi, matrix = losses.mutual_information_loss(t(p1), t(p2), 0.7, t(smoothing), 0.3)
    jmi, jmatrix = jlosses.mutual_information_loss(j(p1), j(p2), 0.7, j(smoothing), 0.3)
    mi_plain, _ = losses.mutual_information_loss(t(p1), t(p2))
    pairs = [
        (losses.kl_gaussian(t(dist)), jlosses.kl_gaussian(j(dist))),
        (losses.entropy_logits(t(logits)), jlosses.entropy_logits(j(logits))),
        (losses.joint_probability_matrix(t(p1), t(p2)), jlosses.joint_probability_matrix(j(p1), j(p2))),
        (mi, jmi), (matrix, jmatrix),
        (mi_plain, jlosses.mutual_information_loss(j(p1), j(p2))[0]),
        (losses.acmv_loss(t(movements), t(p1)), jlosses.acmv_loss(j(movements), j(p1))),
    ]
    for mode in ("lsgan", "vanilla"):
        for real in (True, False):
            pairs.append((losses.gan_loss(t(prediction), real, mode), jlosses.gan_loss(j(prediction), real, mode)))
    for axis in range(3):
        pairs.append((losses.camera_relative_movements(t(movements), t(camera_rotations), axis),
                      jlosses.camera_relative_movements(j(movements), j(camera_rotations), axis)))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="single camera"):
        losses.camera_relative_movements(t(movements), t(np.repeat(camera_rotations, 2, axis=2)), 2)
    with pytest.raises(ValueError, match="acmv_rotation_axis"):
        losses.camera_relative_movements(t(movements), t(camera_rotations), None)
    with pytest.raises(ValueError, match="unknown gan mode"):
        losses.gan_loss(t(prediction), True, "wgan")
