"""Phase 1 (the VAE feature renderer), the port against the JAX package on
the CPU, at tiny autoencoder widths and VGG19's fixed widths on 32x32
images:

- the encoder in train mode, v8 and v9 (v9 at downsampling (3, 1), which
  adds its `mid_res` blocks): every level's (mean ++ log variance) at 1e-5
  and the running statistics after it at 1e-5;
- `spatial_kl_gaussian` of f32 and bf16 latents at 1e-6 (f32 inside);
- `VGGFeatures` (the five cuts) and `perceptual_loss` at 1e-4 of each
  output's largest (sixteen f32 convolutions), its gradient on the
  reconstruction at 1e-3 of its largest and 1e-4 in the mean (as the
  step's gradients below);
- the torchvision loader (`features.N.*`, conv and ReLU one index each, one
  more per pool) on a synthetic state dict, against the JAX package's
  converter, and from a file;
- one whole phase-1 step (v8, f32, perceptual 0.1, KL 5e-6) with JAX's
  posterior noise replayed: the loss terms at 1e-5, every gradient at 1e-3
  of its tensor's largest (plus 1e-5 of its half's, for the biases that
  feed a batch norm), the parameters and running statistics after the
  step as tests/test_torch_port_train.py holds them, the VGG unchanged.
  The gradient tolerance is JAX's own error: on these inputs the port's
  f32 gradients sit within 5e-6 of a tensor's largest from the same step
  in float64 (a copy of the port with every dtype raised), and the JAX
  package's (XLA on the CPU) within 3.4e-4.

JAX variables come from `jax.eval_shape` plus seeded values
(tests/test_torch_port_phase3.py's `seeded_tree`).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.eval import perceptual as jperceptual
from playableenvironments_tpu.models.autoencoder import MultiresAutoencoder as JaxAutoencoder
from playableenvironments_tpu.train import losses as jlosses
from playableenvironments_tpu.train import trainer_autoencoder as jtrainer
from playableenvironments_tpu.train.state import create_train_state, make_optimizer
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.compat.from_flax import load_autoencoder, load_vgg
from playableenvironments_tpu_torch.eval import perceptual
from playableenvironments_tpu_torch.models.autoencoder import MultiresAutoencoder
from playableenvironments_tpu_torch.train import losses, trainer_autoencoder
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_decoder import NO_OPT
from test_torch_port_phase3 import gradient_tolerances, seeded_tree

AE = dict(bottleneck_features=16, bottleneck_blocks=1, downsampling_layers_count=(2, 1))
IMAGES = (4, 32, 32, 3)
LEARNING_RATE = 4e-4


def t(x):
    return torch.from_numpy(np.array(x))


def autoencoder_variables(cfg, seed):
    ae = JaxAutoencoder(cfg)
    shapes = jax.eval_shape(lambda k: ae.init(k, jnp.zeros(IMAGES), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return {kind: seeded_tree(shapes[kind], rng) for kind in ("params", "batch_stats")}


@functools.lru_cache(maxsize=None)
def vgg_variables(seed=7):
    net = jperceptual.VGGFeatures(jperceptual.VGG19_PLAN, jperceptual.VGG19_CUTS)
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.zeros(IMAGES)), jax.random.PRNGKey(0))
    return {"params": seeded_tree(shapes["params"], np.random.default_rng(seed))}


@pytest.mark.parametrize("variant,downsampling", [("v8", (2, 1)), ("v9", (3, 1))])
def test_encoder_train_mode_matches_jax(variant, downsampling):
    kwargs = dict(AE, variant=variant, downsampling_layers_count=downsampling)
    cfg = jax_config.AutoencoderConfig(**kwargs)
    variables = autoencoder_variables(cfg, seed=1)
    images = np.random.default_rng(2).random(IMAGES).astype(np.float32)
    ae = JaxAutoencoder(cfg)
    encode = jax.jit(lambda v, x: ae.apply(v, x, True, method=JaxAutoencoder.encode, mutable=["batch_stats"]),
                     compiler_options=NO_OPT)
    ref, mutated = jax.device_get(encode(variables, jnp.asarray(images)))
    model = MultiresAutoencoder(port_config.AutoencoderConfig(**kwargs), device="cpu")
    load_autoencoder(model, variables)
    if variant == "v9":
        assert any(name.startswith("mid_res_") for name, _ in model.encoder.named_children())
    got = model.encode(t(images), train=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    expected = MultiresAutoencoder(port_config.AutoencoderConfig(**kwargs), device="cpu")
    load_autoencoder(expected, {"params": variables["params"], "batch_stats": mutated["batch_stats"]})
    for name, buffer in model.encoder.named_buffers():
        np.testing.assert_allclose(buffer.numpy(), expected.encoder.get_buffer(name).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_spatial_kl_gaussian_matches_jax(dtype):
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 6, 8, 16)).astype(np.float32)).astype(dtype)
    ref = jlosses.spatial_kl_gaussian(x)
    got = losses.spatial_kl_gaussian(torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_vgg_features_and_perceptual_loss_match_jax():
    variables = vgg_variables()
    rng = np.random.default_rng(4)
    observations = rng.random(IMAGES).astype(np.float32)
    reconstructed = rng.random(IMAGES).astype(np.float32)
    reconstructed[:, :8] = 0.0  # flat regions: ReLU zeros tie in the pools' windows
    net = jperceptual.VGGFeatures()

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def run(observations, reconstructed):
        features = net.apply(variables, reconstructed)
        loss = lambda r: jperceptual.perceptual_loss(variables, observations, r)  # noqa: E731
        (value, levels), grad = jax.value_and_grad(loss, has_aux=True)(reconstructed)
        return features, value, levels, grad

    features, value, levels, grad = jax.device_get(run(jnp.asarray(observations), jnp.asarray(reconstructed)))
    vgg = perceptual.init_vgg19(device="cpu")
    load_vgg(vgg, variables)
    got = vgg(t(reconstructed))
    assert len(got) == 5
    for g, r in zip(got, features):
        r = np.transpose(r, (0, 3, 1, 2))
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())
    rec = t(reconstructed).requires_grad_(True)
    got_value, got_levels = perceptual.perceptual_loss(vgg, t(observations), rec)
    got_value.backward()
    np.testing.assert_allclose(got_value.detach().numpy(), value, rtol=1e-4)
    np.testing.assert_allclose(torch.stack(got_levels).detach().numpy(), np.asarray(levels), rtol=1e-4)
    np.testing.assert_allclose(rec.grad.numpy(), grad, rtol=0, atol=1e-3 * np.abs(grad).max())
    assert np.abs(rec.grad.numpy() - grad).mean() <= 1e-4 * np.abs(grad).max()
    assert all(p.grad is None for p in vgg.parameters())


def synthetic_torchvision_state(rng):
    """A torchvision VGG19 `features` state dict of random tensors (OIHW)."""
    state, idx, channels = {}, 0, 3
    for widths in jperceptual.VGG19_PLAN:
        for width in widths:
            state[f"features.{idx}.weight"] = torch.from_numpy(rng.normal(size=(width, channels, 3, 3)).astype(np.float32))
            state[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(size=(width,)).astype(np.float32))
            idx, channels = idx + 2, width
        idx += 1
    return state


def test_torchvision_vgg_loader_matches_the_jax_converter(tmp_path):
    state = synthetic_torchvision_state(np.random.default_rng(5))
    assert max(int(k.split(".")[1]) for k in state) == 34  # relu5_4's conv in torchvision's numbering
    converted = jperceptual.convert_torch_vgg_state_dict({k: v.numpy() for k, v in state.items()})
    reference = perceptual.init_vgg19(device="cpu")
    layers = {name for name, _ in reference.named_children()}  # up to relu5_1, as VGGFeatures runs
    load_vgg(reference, {"params": {k: v for k, v in converted["params"].items() if k in layers}})
    vgg = perceptual.load_torch_vgg_state_dict(perceptual.init_vgg19(device="cpu"), state)
    for name, value in reference.state_dict().items():
        assert torch.equal(vgg.state_dict()[name], value), name
    torch.save(state, tmp_path / "vgg19.pth")
    from_file = perceptual.load_torch_vgg_weights(str(tmp_path / "vgg19.pth"), perceptual.init_vgg19(device="cpu"))
    assert all(torch.equal(from_file.state_dict()[n], v) for n, v in reference.state_dict().items())
    with pytest.raises(FileNotFoundError):
        perceptual.load_torch_vgg_weights(str(tmp_path / "absent.pth"), perceptual.init_vgg19(device="cpu"))


def training_config(module):
    return module.AutoencoderTrainingConfig(learning_rate=LEARNING_RATE, perceptual_lambda=0.1, kl_lambda=5e-6)


@functools.lru_cache(maxsize=None)
def jax_step():
    """(variables before, (metrics, grads, variables after), noise draws)."""
    cfg = jax_config.AutoencoderConfig(**AE)
    # Built without the perceptual term, which would initialize VGG19
    # eagerly; its config and seeded VGG variables are set afterwards.
    trainer = jtrainer.AutoencoderTrainer(cfg, dataclasses.replace(training_config(jtrainer), perceptual_lambda=0.0))
    trainer.cfg = training_config(jtrainer)
    trainer.vgg_variables = vgg_variables()
    variables = autoencoder_variables(cfg, seed=6)
    tx = make_optimizer(LEARNING_RATE, trainer.cfg.lr_gamma, trainer.cfg.lr_decay_iterations)
    state = create_train_state(variables["params"], variables["batch_stats"], tx)
    images = jnp.asarray(np.random.default_rng(7).random(IMAGES).astype(np.float32))
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def step(state, key):
        with recorded_draws(("normal",)) as draws:
            def loss_fn(p):
                return trainer.compute_losses(p, state.batch_stats, images, key)

            (_, (metrics, new_stats, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        names[:] = [name for name, _ in draws]
        new_state = state.apply_gradients(grads).replace(batch_stats=new_stats)
        return metrics, grads, {"params": new_state.params, "batch_stats": new_state.batch_stats}, \
            [v for _, v in draws]

    metrics, grads, after, values = jax.device_get(step(state, jax.random.PRNGKey(8)))
    return variables, (metrics, grads, after), [(n, np.asarray(v)) for n, v in zip(names, values)], np.asarray(images)


def port_autoencoder(tree):
    model = MultiresAutoencoder(port_config.AutoencoderConfig(**AE), device="cpu")
    load_autoencoder(model, tree)
    return model


@functools.lru_cache(maxsize=None)
def port_step(remat=False):
    """The port's step on JAX's draws from JAX's variables: (metrics,
    grads, state after, the VGG unchanged)."""
    before, _, draws, images = jax_step()
    cfg = dataclasses.replace(training_config(trainer_autoencoder), remat=remat)
    trainer = trainer_autoencoder.AutoencoderTrainer(port_config.AutoencoderConfig(**AE), cfg, device="cpu")
    load_autoencoder(trainer.model, before)
    load_vgg(trainer.vgg, vgg_variables())
    vgg_before = {k: v.clone() for k, v in trainer.vgg.state_dict().items()}
    model = trainer.model
    model.train()
    trainer.optimizer.zero_grad()
    replay = Replay(draws)
    _, metrics, _ = trainer.compute_losses(t(images), replay)
    assert not replay.draws and replay.streams == ["sampling", "sampling"]
    metrics["loss"].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    trainer.optimizer.step()
    vgg_still = all(torch.equal(v, vgg_before[k]) for k, v in trainer.vgg.state_dict().items())
    return ({k: v.detach() for k, v in metrics.items()}, grads, {k: v.clone() for k, v in model.state_dict().items()},
            vgg_still)


def test_phase1_step_matches_jax():
    check_phase1_step_against_jax(remat=False)


def test_phase1_remat_step_matches_jax():
    """With `remat` (the autoencoder's stages and blocks and the perceptual
    term rematerialized), against the same JAX step."""
    check_phase1_step_against_jax(remat=True)


def check_phase1_step_against_jax(remat):
    before, (jmetrics, jgrads, jafter), draws, images = jax_step()
    assert [name for name, _ in draws] == ["normal", "normal"]  # one posterior draw per level
    metrics, grads, state, vgg_still = port_step(remat)
    assert set(metrics) == set(jmetrics) == {"loss", "reconstruction_loss", "kl_loss", "perceptual_loss"}
    for name, value in metrics.items():
        np.testing.assert_allclose(value.detach().numpy(), jmetrics[name], rtol=1e-5, err_msg=name)
    ref_grads = port_autoencoder({"params": jgrads, "batch_stats": before["batch_stats"]}).state_dict()
    atol = {name: 10 * tol for name, tol in gradient_tolerances(ref_grads, list(grads)).items()}
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(), rtol=0, atol=atol[name], err_msg=name)
    ref = port_autoencoder(jafter).state_dict()
    start = port_autoencoder(before).state_dict()
    for name, value in state.items():
        if name in grads:
            diff, grad = (value - ref[name]).abs(), ref_grads[name].abs()
            clear = grad > max(1e-3 * grad.max().item(), 2 * atol[name])
            assert bool((diff[clear] <= 1e-6 + 1e-5 * ref[name][clear].abs()).all()), name
            assert bool((diff <= 2 * LEARNING_RATE + 1e-6).all()), name
        else:
            np.testing.assert_allclose(value.numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
            assert not torch.equal(value, start[name]), name
    assert vgg_still


def test_phase1_remat_step_matches_the_plain_step():
    """`remat` in phase 1: the same loss terms, gradients and running
    statistics (moved once, not again by the recompute) as the step
    without it, to 1e-6 relative."""
    (metrics, grads, state, _), (ref_metrics, ref_grads, ref_state, _) = port_step(True), port_step(False)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.numpy(), ref_metrics[name].numpy(), rtol=1e-6, err_msg=name)
    for name, grad in grads.items():
        scale = ref_grads[name].abs().max().item()
        np.testing.assert_allclose(grad.numpy(), ref_grads[name].numpy(), rtol=0, atol=1e-6 * scale + 1e-12,
                                   err_msg=name)
    for name, value in state.items():
        np.testing.assert_allclose(value.numpy(), ref_state[name].numpy(), rtol=1e-6, atol=1e-9, err_msg=name)
